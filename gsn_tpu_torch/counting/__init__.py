from .orbits import (PatternInfo, automorphism_orbits,
                     induced_edge_automorphism_orbits,
                     line_graph_edge_automorphism_orbits)
from .counts import (count_identifiers, subgraph_isomorphism_edge_counts,
                     subgraph_isomorphism_vertex_counts)
from .vf2 import (build_adjacency, count_automorphisms,
                  enumerate_subgraph_isomorphisms)

__all__ = [
    "PatternInfo",
    "automorphism_orbits",
    "induced_edge_automorphism_orbits",
    "line_graph_edge_automorphism_orbits",
    "count_identifiers",
    "subgraph_isomorphism_edge_counts",
    "subgraph_isomorphism_vertex_counts",
    "build_adjacency",
    "count_automorphisms",
    "enumerate_subgraph_isomorphisms",
]
