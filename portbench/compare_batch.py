"""The comparison that decides ``correct`` in a cell of batched queries
(``systems/lattice_batch.py``): the batch's contract is that each lane gives
what its query gives alone, so each checked lane is one query of
`compare.lattice_checks`, held to the plain reference's single solve.

The numbers, as `compare.py` defines them: ``graph_rows_differ``,
``graph_w_err``, ``ustar_rel_err``, ``bundle_gap`` and
``bundle_score_err``, each per-lane number the worst over the lanes
checked.  A lane given another lane's outputs, or stopped short of its own
count, reads a large ``ustar_rel_err``.
"""

from __future__ import annotations

import torch

from . import compare


def lattice_batch_checks(Y: torch.Tensor, cfg: dict, traffic: dict, outputs: dict) -> dict:
    """The numbers of a batched lattice cell.  ``outputs``: the program's
    graph (idx, w) and, per lane checked, its ``psi``, ``bundle`` and
    ``ustar``; ``traffic["bundle_batch"]`` gives the bundles' k and alpha."""
    single = {"steps": [["set_query", {}], ["bundle", traffic["bundle_batch"]]]}
    return compare.lattice_checks(Y, cfg, single, outputs)
