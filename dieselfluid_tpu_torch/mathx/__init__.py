"""Domain math torch lacks: quaternions, polar coords, transforms, rays, and
the reference's scalar constants. Counterpart of dieselfluid_tpu/mathx."""

import torch

from dieselfluid_tpu_torch.mathx import polar, quaternion, ray, transforms  # noqa: F401

DEG2RAD = 0.01745329251994444444
RAD2DEG = 57.2957795130823158
PI = 3.141592653589
EPSILON = 0.00000001


def clamp1f(x, lo, hi):
    """ref: math/common/utility.go Clamp1f."""
    return torch.clamp(torch.as_tensor(x), lo, hi)
