"""Model configurations, cell shapes and the architecture registry."""

from repro_torch.configs.cells import Cell
from repro_torch.configs.registry import ARCH_IDS, all_cells, get_arch, list_archs

__all__ = ["ARCH_IDS", "Cell", "all_cells", "get_arch", "list_archs"]
