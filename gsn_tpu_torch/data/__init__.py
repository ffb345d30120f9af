from .encoding import OneHotMax, OneHotUnique, encode
from .pipeline import build_pattern_infos, compute_degrees, generate_dataset
from .synthetic import make_zinc_like

__all__ = [
    "OneHotMax", "OneHotUnique", "encode",
    "build_pattern_infos", "compute_degrees", "generate_dataset",
    "make_zinc_like",
]
