"""The port's whole real-time frame against the JAX package's with
`use_restir` False, in the harness of tests/test_torch_fused_slice.py
(64×64, two frames from identical state; the JAX side compiles its own
path trace + denoise), on that file's bars: u8 mean |Δ| ≤ 1.0 and ≥ 90%
of pixels with every channel within 3/255.  The JAX side gets no previous
reservoirs, as the reference's `_build_run` passes none with ReSTIR off
(rtvb_tpu/render/renderer.py)."""
import pytest
import torch

from rtvb_tpu.core.config import Settings as JSettings
from rtvb_tpu.render.renderer import Engine as JEngine
from test_torch_fused_slice import (W, H, _jax_trace_denoise_fn, _shipped,
                                    _two_frames, _u8_matches)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def frames():
    settings = _shipped(W, H).replace(rendering={"use_restir": False})
    je = JEngine(settings=JSettings.from_dict(settings.to_dict()),
                 backend="xla")
    assert not je.settings.rendering.use_restir and H == W
    return _two_frames(settings, _jax_trace_denoise_fn(je))


@pytest.mark.parametrize("frame", [0, 1])
def test_whole_frame_u8_matches(frames, frame):
    _u8_matches(frames[frame], W, f"ReSTIR off, whole frame {frame + 1}")
