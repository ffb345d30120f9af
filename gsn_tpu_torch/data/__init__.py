from .encoding import OneHotMax, OneHotUnique, encode
from .pipeline import build_pattern_infos, compute_degrees, generate_dataset
from .directional import assemble_directions, laplacian_eig
from .synthetic import make_dgn_like, make_zinc_like

__all__ = [
    "OneHotMax", "OneHotUnique", "encode",
    "build_pattern_infos", "compute_degrees", "generate_dataset",
    "assemble_directions", "laplacian_eig", "make_dgn_like",
    "make_zinc_like",
]
