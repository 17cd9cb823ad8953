from .encoder import ManyHotEncoder
from .events import find_contiguous_regions

__all__ = ["ManyHotEncoder", "find_contiguous_regions"]
