"""The dynamic-resolution rungs of the port against the JAX package:
* `Engine._internal_size` and `set_render_scale` (sizes, the state reset)
  for the four rungs at three output sizes;
* `DynamicResolution` on the scripted frame times of
  tests/test_interactive.py::test_dynamic_resolution_walks_rungs.
The whole frame at the 2/3 rung against JAX is in
tests/test_torch_fused_slice.py, which shares its JAX path-trace compile.
"""
import functools
from types import SimpleNamespace

import pytest

from rtvb_tpu.apps.interactive import DynamicResolution as JDynRes
from rtvb_tpu.render.renderer import Engine as JEngine
from rtvb_tpu_torch.apps.interactive import DynamicResolution
from rtvb_tpu_torch.render.renderer import Engine

RUNGS = (1.0, 0.75, 2.0 / 3.0, 0.5)


def _stub(cls, out_w, out_h):
    """An object carrying just what cls's sizing methods read and write."""
    e = SimpleNamespace(out_width=out_w, out_height=out_h, width=out_w,
                        height=out_h, render_scale=1.0, restir_state="r",
                        denoiser_state="d", _accum="a", _accum_n=3)
    e._internal_size = functools.partial(cls._internal_size, e)
    return e


@pytest.mark.parametrize("out", [(1920, 1080), (384, 216), (96, 48)])
def test_internal_size_and_set_render_scale_match_jax(out):
    port, ref = _stub(Engine, *out), _stub(JEngine, *out)
    # walk down the ladder, repeat a rung (no reset), and back up
    for scale in RUNGS + (0.5, 1.0, 2.0 / 3.0):
        assert Engine._internal_size(port, scale) == \
            JEngine._internal_size(ref, scale)
        for e in (port, ref):
            e.restir_state, e.denoiser_state = "r", "d"
        Engine.set_render_scale(port, scale)
        JEngine.set_render_scale(ref, scale)
        assert (port.width, port.height, port.render_scale) == \
            (ref.width, ref.height, ref.render_scale)
        assert (port.restir_state is None) == (ref.restir_state is None)
        assert (port.denoiser_state is None) == (ref.denoiser_state is None)


def test_dynamic_resolution_matches_jax():
    times = [40.0] * 50 + [4.0] * 200 + [16.9] * 60 + [25.0] * 20 \
        + [9.0] * 30
    port = DynamicResolution(target_fps=60.0, min_scale=0.5, start_scale=1.0)
    ref = JDynRes(target_fps=60.0, min_scale=0.5, start_scale=1.0)
    seq = [port.update(t) for t in times]
    assert seq == [ref.update(t) for t in times]
    assert set(seq) == set(RUNGS)
    assert seq[49] == 0.5 and seq[249] == 1.0
