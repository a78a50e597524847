"""The port's flythrough path (rtvb_tpu_torch/utils/flypath.py) against
the JAX package's (rtvb_tpu/utils/flypath.py): the same poses, and the
same calls on an engine's camera API, from the same start."""
import pytest

from rtvb_tpu.utils import flypath as jfly

from rtvb_tpu_torch.utils import flypath as pfly


@pytest.mark.parametrize("frames", [1, 2, 24])
def test_flythrough_pose_matches_jax(frames):
    pos0, yaw0 = (32.0, 18.0, 8.0), 1.1
    for i in range(frames):
        assert pfly.flythrough_pose(pos0, yaw0, i, frames) == \
            jfly.flythrough_pose(pos0, yaw0, i, frames)


class _Cam:
    def __init__(self, pos, yaw):
        self.pos_x, self.pos_y, self.pos_z = pos
        self.yaw, self.pitch = yaw, -0.35


class _JaxEngine:
    """The JAX engine's camera calls that apply_flythrough makes."""

    def __init__(self, pos, yaw):
        self.camera = _Cam(pos, yaw)
        self.calls = []

    def set_camera(self, pos=None, yaw=None):
        self.calls.append((pos, yaw))
        self.camera = _Cam(pos, yaw)


class _PortEngine:
    """The port engine's: the pose from its host copy, then set_camera."""

    def __init__(self, pos, yaw):
        self.pose = (pos, yaw, -0.35)
        self.calls = []

    def camera_pose(self):
        return self.pose

    def set_camera(self, pos=None, yaw=None):
        self.calls.append((pos, yaw))
        self.pose = (pos, yaw, self.pose[2])


def test_apply_flythrough_matches_jax():
    start = ((32.0, 18.0, 8.0), 1.1)
    je, pe = _JaxEngine(*start), _PortEngine(*start)
    j0 = p0 = (None, None)
    for i in range(24):
        j0 = jfly.apply_flythrough(je, i, 24, *j0)
        p0 = pfly.apply_flythrough(pe, i, 24, *p0)
        assert p0 == j0
    assert pe.calls == je.calls and len(pe.calls) == 24
    # explicit start poses pass through
    assert pfly.apply_flythrough(pe, 3, 8, (1.0, 2.0, 3.0), 0.5) == \
        ((1.0, 2.0, 3.0), 0.5)
