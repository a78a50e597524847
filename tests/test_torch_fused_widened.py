"""The port's whole real-time frame against the JAX package's at settings
past the shipped ones that the dev panel reaches (Settings.adjust):
atrous_iterations 9 with phi_normal 80.0 (K6's plain version at steps up
to 256, its normal weight by pow) and restir_temporal_samples 6 (K4's
plain version at more taps than its compile-time instances take).  In the
harness of tests/test_torch_fused_slice.py (64×64, two frames from
identical state; the JAX side compiles its own path trace + denoise), on
that file's bars: u8 mean |Δ| ≤ 1.0 and ≥ 90% of pixels with every
channel within 3/255."""
import pytest
import torch

from rtvb_tpu.core.config import Settings as JSettings
from rtvb_tpu.render.renderer import Engine as JEngine
from test_torch_fused_slice import (W, H, _jax_trace_denoise_fn, _shipped,
                                    _two_frames, _u8_matches)

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def frames():
    settings = _shipped(W, H).replace(
        rendering={"restir_temporal_samples": 6},
        denoising={"atrous_iterations": 9, "phi_normal": 80.0})
    je = JEngine(settings=JSettings.from_dict(settings.to_dict()),
                 backend="xla")
    assert je.settings.denoising.atrous_iterations == 9 and H == W
    return _two_frames(settings, _jax_trace_denoise_fn(je))


@pytest.mark.parametrize("frame", [0, 1])
def test_whole_frame_u8_matches(frames, frame):
    _u8_matches(frames[frame], W, f"widened settings, whole frame "
                f"{frame + 1}")
