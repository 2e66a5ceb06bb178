from . import quaternion, se3, so3
from .se3 import Pose

__all__ = ["quaternion", "se3", "so3", "Pose"]
