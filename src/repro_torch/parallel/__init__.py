"""Distributed LP on ``torch.distributed`` (DESIGN.md §6): device meshes
(:mod:`.mesh`), compressed and decomposed collectives (:mod:`.collectives`)
and the edge × seed sharded solver (:mod:`.lp_sharded`).  Importing this
package starts no process group."""
