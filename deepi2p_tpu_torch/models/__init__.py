"""Models of the port: the frustum keypoint detector and its parts."""
from .detector import KeypointDetector, build_detector
from .from_jax import load_state_dict, state_dict_from_flax

__all__ = ["KeypointDetector", "build_detector", "load_state_dict",
           "state_dict_from_flax"]
