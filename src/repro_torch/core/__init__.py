"""Core library: the paper's contribution (DHLP-1/2) as composable modules."""
from repro_torch.core.blocked_csr import (
    BlockedCSR,
    blocked_csr_from_network,
    split_blocked_csr_from_network,
)
from repro_torch.core.closed_form import dhlp1_inner_solution, fixed_seed_solution
from repro_torch.core.network import (
    GraphDelta,
    HeteroCOO,
    HeteroNetwork,
    NormalizedNetwork,
    from_numpy,
    seeds_for_nodes,
    seeds_identity,
)
from repro_torch.core.normalize import (
    bipartite_normalize,
    spectral_radius_upper_bound,
    symmetric_normalize,
)
from repro_torch.core.ranking import (
    LPOutputs,
    extract_outputs,
    rank_of,
    symmetrize,
    topk_exclusive,
)
from repro_torch.core.reference import (
    RefResult,
    heterlp_single_seed,
    minprop_single_seed,
    run_all_seeds,
)
from repro_torch.core.solver import HeteroLP, LPConfig, SolveResult

__all__ = [
    "BlockedCSR",
    "GraphDelta",
    "HeteroCOO",
    "HeteroLP",
    "HeteroNetwork",
    "LPConfig",
    "LPOutputs",
    "NormalizedNetwork",
    "RefResult",
    "SolveResult",
    "bipartite_normalize",
    "blocked_csr_from_network",
    "dhlp1_inner_solution",
    "extract_outputs",
    "fixed_seed_solution",
    "from_numpy",
    "heterlp_single_seed",
    "minprop_single_seed",
    "rank_of",
    "run_all_seeds",
    "seeds_for_nodes",
    "seeds_identity",
    "spectral_radius_upper_bound",
    "split_blocked_csr_from_network",
    "symmetric_normalize",
    "symmetrize",
    "topk_exclusive",
]
