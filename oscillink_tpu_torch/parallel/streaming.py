"""Streaming and incremental updates: the append-only half of the
scale-out composition contract (port of
``oscillink_tpu/parallel/streaming.py``).

Appends accumulate in a host buffer; at ``shard_size`` rows the buffer is
integrated as one micro-lattice solve at that fixed shape (the shared
`hierarchical.shard_solve_body`, whose operator is kernel K1 on the card).
A partial buffer is zero-padded: `ops.graph.normalize_rows` maps a zero row
to zero, so its cosine similarity with every row is exactly 0, the mutual
mask keeps only ``w > 0`` edges, and the padding is inert in the graph, the
CG iterates and the receipts.  The summary table is preallocated at
``[max_shards, D]``; empty slots are zero rows with gate 0 (inert by the
same argument).  Each flush returns a delta receipt (the new shard's
receipt, the re-solved super level, the composed ΔH and
``deltaH_since_last``); gates propagate downward (`propagate_gates`); with
``receipt_secret`` every shard receipt and every delta receipt carry HMAC
blocks; when the summary table fills, `consolidate()` settles the summaries
themselves as a micro-lattice and collapses them into one pseudo-shard, so
append streams are unbounded with ``deltaH_composed`` and ``total_rows``
continuous across generations; `bundle(k)` retrieves across the stream from
a bounded pool of per-flush top settled rows with the reference's MMR rule.

Shard solves match `hierarchical.hierarchical_settle` (same energy, same
summary convention), so a fully flushed streaming lattice composes the
receipts the batch tier produces on the same shard partition.
"""

from __future__ import annotations

import hashlib
import json
from typing import Any, Optional

import numpy as np
import torch

from ..models.coherence import EnergyParams, solve_stationary
from ..ops.graph import build_graph, stable_topk
from ..utils.device import DeviceLike, resolve_device
from .hierarchical import shard_solve_body

__all__ = ["StreamingLattice"]


def _pool_topk(Ustar: torch.Tensor, psi: torch.Tensor, take: int, m: int):
    """Top-``m`` settled rows by query alignment (live rows only): the
    per-shard compressed node diagnostics the bundle draws from.  Returns
    (aligns, local row ids, settled rows); padded entries carry -inf.
    Ties go to the lower row, as ``lax.top_k``'s do."""
    u_n = Ustar / (torch.linalg.vector_norm(Ustar, dim=1, keepdim=True) + 1e-12)
    psi_n = psi / (torch.linalg.vector_norm(psi) + 1e-12)
    align = u_n @ psi_n
    rows = torch.arange(Ustar.shape[0], device=Ustar.device)
    align = torch.where(rows < take, align, -torch.inf)
    vals, idx = stable_topk(align[None, :], m)
    return vals[0], idx[0].to(torch.int32), Ustar[idx[0]]


def _super_solve_gated(summaries, psi, live, lam, k, tol, max_iters):
    """Super-level solve over the preallocated summary table.  ``live`` is
    the 0/1 slot mask used as gates: empty slots are zero rows (inert in
    the graph) with no query coupling, so the solve equals the unpadded
    solve over the live summaries alone."""
    g = build_graph(summaries, k)
    Ustar, iters, res = solve_stationary(g, None, summaries, psi, live, lam, tol=tol,
                                         max_iters=max_iters)
    diff = Ustar - summaries
    dH = torch.sum(diff * (lam.lamG * diff))
    u_n = Ustar / (torch.linalg.vector_norm(Ustar, dim=1, keepdim=True) + 1e-12)
    psi_n = psi / (torch.linalg.vector_norm(psi) + 1e-12)
    align = (u_n @ psi_n) * live  # empty slots report 0
    return Ustar, align, dH, iters, res


class StreamingLattice:
    """Append-only lattice-of-lattices (SCALING.md:61-69, implemented).

    Parameters mirror `hierarchical_settle`; ``shard_size`` is the
    integration bucket (every micro-solve runs at exactly this many rows)
    and ``max_shards`` bounds the summary table.  The solves run on
    ``device`` (``cuda`` unless given).
    """

    def __init__(
        self,
        psi: np.ndarray,
        *,
        shard_size: int = 256,
        max_shards: int = 64,
        kneighbors: int = 6,
        super_k: int = 3,
        lamG: float = 1.0,
        lamC: float = 0.5,
        lamQ: float = 4.0,
        tol: float = 1e-4,
        max_iters: int = 64,
        receipt_secret: Optional[bytes | str] = None,
        auto_consolidate: bool = True,
        candidate_pool: int = 32,
        pool_cap: int = 1024,
        device: DeviceLike = None,
    ):
        psi = np.asarray(psi, dtype=np.float32)
        if psi.ndim != 1:
            raise ValueError("psi must be a 1-D query vector")
        if shard_size < 2:
            raise ValueError("shard_size must be >= 2")
        if max_shards < 1:
            raise ValueError("max_shards must be >= 1")
        if lamG <= 0:
            raise ValueError("lamG must be > 0 (SPD)")
        if auto_consolidate and max_shards > shard_size:
            # consolidation reuses the [shard_size, D] micro-solve executable
            # on the summary table, so the table must fit one bucket
            raise ValueError(
                "auto_consolidate requires max_shards <= shard_size "
                f"(got {max_shards} > {shard_size})"
            )
        if auto_consolidate and max_shards < 2:
            # a 1-slot table can never merge (consolidation needs >= 2
            # shards), so the stream would dead-end after one flush
            raise ValueError(
                "auto_consolidate requires max_shards >= 2; pass "
                "auto_consolidate=False for a single-shard lattice"
            )
        self.device = resolve_device(device)
        self.psi = psi
        self._psi_dev = torch.from_numpy(psi).to(self.device)
        self.dim = int(psi.shape[0])
        self.shard_size = int(shard_size)
        self.max_shards = int(max_shards)
        self.kneighbors = int(kneighbors)
        self.super_k = int(super_k)
        self.lam = EnergyParams.make(lamG, lamC, lamQ, 0.0, device=self.device)
        self.tol = float(tol)
        self.max_iters = int(max_iters)
        self.receipt_secret = receipt_secret
        self.auto_consolidate = bool(auto_consolidate)

        self._buf_rows: list[np.ndarray] = []
        self._buf_gates: list[np.ndarray] = []
        self._summaries = np.zeros((max_shards, self.dim), dtype=np.float32)
        self._live = np.zeros(max_shards, dtype=np.float32)
        self._shard_rows: list[int] = []  # PHYSICAL live rows per shard
        self._shard_receipts: list[dict[str, Any]] = []
        self._ustars: list[torch.Tensor] = []  # padded [shard_size, D] per shard
        self._node_gates: list[np.ndarray] = []  # live gates per shard
        self._super: Optional[dict[str, Any]] = None
        self._deltaH_last = 0.0
        self._seq = 0
        self._rows_integrated = 0  # logical corpus rows ever integrated
        self._generation = 0  # consolidation (recursion) depth

        # cross-stream bundle pool: each flush contributes its top
        # ``candidate_pool`` settled rows (global id, settled alignment,
        # settled vector); bounded at ``pool_cap`` (best-align kept) so the
        # pool survives consolidation without unbounded growth
        self.candidate_pool = int(min(candidate_pool, shard_size))
        self.pool_cap = int(pool_cap)
        self._pool_ids = np.zeros(0, dtype=np.int64)
        self._pool_align = np.zeros(0, dtype=np.float32)
        self._pool_vecs = np.zeros((0, self.dim), dtype=np.float32)

    # ------------------------------------------------------------------ #

    @property
    def n_shards(self) -> int:
        return len(self._shard_rows)

    @property
    def buffered(self) -> int:
        return sum(r.shape[0] for r in self._buf_rows)

    @property
    def total_rows(self) -> int:
        return self._rows_integrated + self.buffered

    @property
    def generation(self) -> int:
        """Consolidation (recursion) depth — 0 until the first merge."""
        return self._generation

    def append(self, Y_new: np.ndarray, gates: Optional[np.ndarray] = None):
        """Buffer rows (SCALING.md step 1); integrates automatically every
        time the buffer reaches ``shard_size`` rows.  Returns the list of
        delta receipts from any flushes this append triggered."""
        Y_new = np.atleast_2d(np.asarray(Y_new, dtype=np.float32))
        if Y_new.shape[1] != self.dim:
            raise ValueError(f"expected dim {self.dim}, got {Y_new.shape[1]}")
        g = (
            np.ones(Y_new.shape[0], dtype=np.float32)
            if gates is None
            else np.clip(np.asarray(gates, dtype=np.float32), 0.0, 1.0)
        )
        if g.shape[0] != Y_new.shape[0]:
            raise ValueError("gates length must match appended rows")
        self._buf_rows.append(Y_new)
        self._buf_gates.append(g)
        receipts = []
        while self.buffered >= self.shard_size:
            receipts.append(self.flush())
        return receipts

    def flush(self) -> Optional[dict[str, Any]]:
        """Integrate up to ``shard_size`` buffered rows as one micro-lattice
        solve (steps 2-3) and return the delta receipt (step 4); None when
        nothing is buffered."""
        if self.buffered == 0:
            return None
        if self.n_shards >= self.max_shards:
            if self.auto_consolidate and self.n_shards >= 2:
                self.consolidate()
            else:
                hint = (
                    "call consolidate()"
                    if 2 <= self.n_shards <= self.shard_size
                    else "rebuild with a larger max_shards"
                )
                raise RuntimeError(
                    f"summary table full ({self.max_shards} shards); {hint}"
                )
        Y = np.concatenate(self._buf_rows, axis=0)
        g = np.concatenate(self._buf_gates, axis=0)
        take = min(Y.shape[0], self.shard_size)
        Y_take, g_take = Y[:take], g[:take]
        rest_Y, rest_g = Y[take:], g[take:]
        self._buf_rows = [rest_Y] if rest_Y.shape[0] else []
        self._buf_gates = [rest_g] if rest_g.shape[0] else []

        pad = self.shard_size - take
        # zero rows + zero gates are bit-exactly inert (module docstring)
        Y_pad = np.pad(Y_take, ((0, pad), (0, 0)))
        g_pad = np.pad(g_take, (0, pad))

        k_local = min(self.kneighbors, self.shard_size - 1)
        Ustar, summary, dH, align, iters_h, res_h = shard_solve_body(
            self._tensor(Y_pad), self._psi_dev, self._tensor(g_pad), self.lam, k_local,
            self.tol, self.max_iters,
        )
        slot = self.n_shards
        summary_h, dH_h, align_h = summary.cpu().numpy(), float(dH), float(align)
        self._summaries[slot] = summary_h
        self._live[slot] = 1.0
        self._shard_rows.append(take)
        rows_before = self._rows_integrated
        self._rows_integrated += take

        # contribute this bucket's top settled rows to the bundle pool
        if self.candidate_pool > 0:
            vals, idx, vecs = (t.cpu().numpy() for t in _pool_topk(
                Ustar, self._psi_dev, take, self.candidate_pool))
            keep = np.isfinite(vals)
            self._pool_insert(
                rows_before + idx[keep].astype(np.int64), vals[keep], vecs[keep]
            )
        self._ustars.append(Ustar)
        self._node_gates.append(g_take)
        shard_receipt = {
            "shard": slot,
            "generation": self._generation,
            "rows": int(take),
            "deltaH": float(dH_h),
            "align": float(align_h),
            "iters": int(iters_h),
            "res": float(res_h),
        }
        if self.receipt_secret is not None:
            from ..core.receipts import sign_component

            shard_receipt["signature"] = sign_component(
                dict(shard_receipt), self.receipt_secret
            )
        self._shard_receipts.append(shard_receipt)
        self._resolve_super()
        self._seq += 1
        return self.delta_receipt(new_shard=shard_receipt)

    def consolidate(self) -> dict[str, Any]:
        """Recursive lattice-of-lattices merge (the reference SCALING.md's
        recursion clause, applied incrementally): settle a micro-lattice over
        the CURRENT summary table and collapse every shard into one
        consolidated pseudo-shard, freeing ``max_shards - 1`` slots for new
        appends.  The merge reuses the same [shard_size, D] compiled
        executable as ordinary flushes (guaranteed by the
        ``max_shards <= shard_size`` init check).

        The consolidated receipt absorbs its children: its ``deltaH`` is the
        children's total plus the merge solve's own drop, and ``rows`` is the
        children's logical row total — `deltaH_composed` and `total_rows`
        stay continuous across generations.  Children's per-node gates and
        settled rows are released (their fault-domain receipts were already
        emitted at flush time); `propagate_gates` then addresses the
        consolidated shard as one unit."""
        s_old = self.n_shards
        if s_old < 2:
            raise RuntimeError("nothing to consolidate (need >= 2 shards)")
        if s_old > self.shard_size:
            # the merge reuses the [shard_size, D] executable, so the table
            # must fit one bucket (guaranteed at init when auto_consolidate)
            raise RuntimeError(
                f"cannot consolidate {s_old} shards into a {self.shard_size}-"
                "row bucket; rebuild with shard_size >= max_shards"
            )
        child_dH = float(sum(r["deltaH"] for r in self._shard_receipts))
        child_rows = int(sum(r["rows"] for r in self._shard_receipts))

        pad = self.shard_size - s_old
        Y_sum = np.pad(self._summaries[:s_old], ((0, pad), (0, 0)))
        g_sum = np.pad(np.ones(s_old, dtype=np.float32), (0, pad))
        k_local = min(self.kneighbors, self.shard_size - 1)
        Ustar, summary, dH, align, iters_h, res_h = shard_solve_body(
            self._tensor(Y_sum), self._psi_dev, self._tensor(g_sum), self.lam, k_local,
            self.tol, self.max_iters,
        )
        summary_h, dH_h, align_h = summary.cpu().numpy(), float(dH), float(align)
        self._generation += 1
        receipt = {
            "shard": 0,
            "rows": child_rows,
            "deltaH": child_dH + float(dH_h),
            "align": float(align_h),
            "iters": int(iters_h),
            "res": float(res_h),
            "consolidated": True,
            "generation": self._generation,
            "children": s_old,
        }
        if self.receipt_secret is not None:
            from ..core.receipts import sign_component

            receipt["signature"] = sign_component(dict(receipt), self.receipt_secret)

        self._summaries = np.zeros_like(self._summaries)
        self._live = np.zeros_like(self._live)
        self._summaries[0] = summary_h
        self._live[0] = 1.0
        self._shard_rows = [s_old]  # physical rows in the merge solve
        self._shard_receipts = [receipt]
        self._ustars = [Ustar]
        self._node_gates = [np.ones(0, dtype=np.float32)]
        self._resolve_super()
        return receipt

    def _tensor(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)

    def _resolve_super(self):
        k_super = min(self.super_k, max(1, self.max_shards - 1))
        _, align, dH, iters, res = _super_solve_gated(
            self._tensor(self._summaries), self._psi_dev, self._tensor(self._live), self.lam,
            k_super, self.tol, self.max_iters,
        )
        align = align.cpu().numpy()
        live_align = [float(align[s]) for s in range(self.n_shards)]
        self._super = {
            "deltaH": float(dH),
            "align": live_align,
            "ranking": [int(i) for i in np.argsort(-np.asarray(live_align))],
            "iters": int(iters),
            "res": float(res),
        }

    # ------------------------------------------------------------------ #

    def _deltaH_composed(self) -> float:
        if self._super is None:
            return 0.0
        return float(
            sum(r["deltaH"] for r in self._shard_receipts) + self._super["deltaH"]
        )

    def receipt(self) -> dict[str, Any]:
        """Composed receipt WITHOUT consuming the since-last delta (the
        SCALING.md:96-104 API sketch's ``hl.receipt()`` read)."""
        return self._compose(consume=False)

    def delta_receipt(self, new_shard: Optional[dict] = None) -> dict[str, Any]:
        """Composed receipt + deltaH_since_last (consumes the delta)."""
        return self._compose(consume=True, new_shard=new_shard)

    def _compose(
        self, consume: bool, new_shard: Optional[dict] = None
    ) -> dict[str, Any]:
        composed = self._deltaH_composed()
        since = composed - self._deltaH_last
        if consume:
            self._deltaH_last = composed
        payload = {
            "seq": self._seq,
            "n_shards": self.n_shards,
            "generation": self._generation,
            "total_rows": self.total_rows,
            "buffered": self.buffered,
            "deltaH_composed": composed,
            "deltaH_since_last": since,
            "super": self._super,
            "shard_receipts": list(self._shard_receipts),
        }
        if new_shard is not None:
            payload["new_shard"] = new_shard
        payload["composition_sig"] = hashlib.sha256(
            json.dumps(
                {
                    "shards": self.n_shards,
                    "deltaH": [
                        round(r["deltaH"], 6) for r in self._shard_receipts
                    ],
                    "super_deltaH": round(
                        self._super["deltaH"] if self._super else 0.0, 6
                    ),
                    "super_align": [
                        round(a, 6) for a in (self._super or {}).get("align", [])
                    ],
                },
                sort_keys=True,
            ).encode()
        ).hexdigest()
        if self.receipt_secret is not None:
            from ..core.receipts import sign_component

            # sign EVERY field of the composed receipt (tampering with any
            # unsigned field would otherwise pass verify_component); the
            # shard receipts carry their own blocks and are additionally
            # covered here verbatim
            payload["signature"] = sign_component(
                {k: v for k, v in payload.items() if k != "new_shard"},
                self.receipt_secret,
            )
        return payload

    def _pool_insert(
        self, gids: np.ndarray, aligns: np.ndarray, vecs: np.ndarray
    ) -> None:
        self._pool_ids = np.concatenate([self._pool_ids, gids])
        self._pool_align = np.concatenate([self._pool_align, aligns])
        self._pool_vecs = np.concatenate([self._pool_vecs, vecs], axis=0)
        if self._pool_ids.shape[0] > self.pool_cap:
            keep = np.argsort(-self._pool_align)[: self.pool_cap]
            self._pool_ids = self._pool_ids[keep]
            self._pool_align = self._pool_align[keep]
            self._pool_vecs = self._pool_vecs[keep]

    def bundle(
        self, k: int = 10, *, diversify: bool = True, lambda_div: float = 0.5
    ) -> list[dict[str, Any]]:
        """Cross-stream top-``k`` (the API sketch's ``hl.bundle(k)``): draw
        from the bounded candidate pool of per-flush top settled rows, so
        retrieval spans every generation — including shards long since
        consolidated.  Ids are global arrival indices.  ``diversify`` applies
        the reference's MMR rule (lambda_div trade-off, first pick pure
        score) over the stored settled vectors."""
        from ..ops.graph import mmr_select_np

        n = self._pool_ids.shape[0]
        if n == 0:
            return []
        k = min(k, n)
        if not diversify:
            sel = np.argsort(-self._pool_align)[:k]
        else:
            vn = self._pool_vecs / (
                np.linalg.norm(self._pool_vecs, axis=1, keepdims=True) + 1e-12
            )
            sel = mmr_select_np(vn, self._pool_align, k, lambda_div)
        return [
            {
                "id": int(self._pool_ids[i]),
                "score": float(self._pool_align[i]),
                "align": float(self._pool_align[i]),
            }
            for i in sel
        ]

    def propagate_gates(self, super_gates: np.ndarray) -> list[np.ndarray]:
        """Downward gate propagation (SCALING.md:58): scale each flushed
        shard's node gates by its summary's super-level gate.  Returns one
        effective-gate array per shard (live rows only)."""
        super_gates = np.asarray(super_gates, dtype=np.float32)
        if super_gates.shape[0] != self.n_shards:
            raise ValueError(
                f"expected {self.n_shards} super gates, got {super_gates.shape[0]}"
            )
        sg = np.clip(super_gates, 0.0, 1.0)
        return [self._node_gates[s] * sg[s] for s in range(self.n_shards)]

    def shard_ustar(self, shard: int) -> np.ndarray:
        """Settled rows of one flushed shard (live rows only)."""
        rows = self._shard_rows[shard]
        return self._ustars[shard][:rows].cpu().numpy()

    # SCALING.md:96-104 API-sketch name: hl.ingest(batch) == append(batch)
    ingest = append
