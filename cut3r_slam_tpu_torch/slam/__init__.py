from .keyframe import KeyframeStore, SUBMAP_SIZE  # noqa: F401
from .motion_filter import MotionFilter  # noqa: F401
from .factor_graph import FactorGraph  # noqa: F401
from .frontend import TrackFrontend  # noqa: F401
from .mapping import MappingBackend, MappingConfig  # noqa: F401
from .system import SLAMSystem  # noqa: F401
