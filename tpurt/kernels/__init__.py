from .intersect import moller_trumbore, ray_aabb  # noqa: F401
from .trace import trace_closest, trace_any  # noqa: F401
