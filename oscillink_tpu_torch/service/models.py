"""Pydantic request/response models (reference cloud/app/models.py:8-65)."""

from __future__ import annotations

from typing import Optional

from pydantic import BaseModel, Field


class Params(BaseModel):
    # bounds mirror the lattice's SPD guards so invalid energies are 422s
    # at the API boundary, not 500s from the solver (fuzz-found: the
    # reference has the same hole — lamG=-1 reaches its lattice ctor)
    lamG: float = Field(default=1.0, gt=0)
    lamC: float = Field(default=0.5, ge=0)
    lamQ: float = Field(default=4.0, ge=0)
    lamP: float = Field(default=0.0, ge=0)
    kneighbors: int = Field(default=6, ge=1)
    deterministic_k: bool = False
    neighbor_seed: Optional[int] = None
    # graph-build precision mode: auto (exact below OSCILLINK_FAST_SIM_N,
    # fast above) | exact | fast (recall .99) | fastest (.95) | cluster
    # (IVF probing, recall-gated with fast fallback — ops/ivf.py)
    similarity: str = "auto"


class SettleOptions(BaseModel):
    max_iters: int = Field(default=12, ge=1, le=10_000)
    tol: float = Field(default=1e-3, gt=0)
    dt: float = Field(default=1.0, gt=0)
    bundle_k: Optional[int] = Field(default=None, ge=0)
    # False = pure score ranking for the inline bundle (rerank mode)
    bundle_diversify: bool = True
    include_receipt: bool = True


class DiffusionOptions(BaseModel):
    """Server-side screened-diffusion gate derivation.

    Implements the reference's draft proposal
    (docs/cloud/CLOUD_ADVANCED_DIFFUSION_ENDPOINT.md — never shipped
    upstream): when present and enabled, per-node gates are derived by a
    screened-Poisson solve over the lattice's OWN graph
    (`core/lattice.py:diffusion_gates`) before the settle, so the
    similarity scan is paid once instead of the draft's second build.
    Tier-gated like explicit gates (`diffusion_gates` feature)."""

    enable: bool = True
    beta: float = 1.0
    gamma: float = 0.1
    tol: float = 1e-4
    max_iters: int = 256


class SettleRequest(BaseModel):
    Y: list[list[float]] = Field(..., description="Matrix N x D (list of rows)")
    psi: Optional[list[float]] = None
    gates: Optional[list[float]] = None
    chain: Optional[list[int]] = None
    params: Params = Params()
    options: SettleOptions = SettleOptions()
    diffusion: Optional[DiffusionOptions] = None


class BundleRequest(SettleRequest):
    bundle_k: int = 8
    alpha: float = 0.5
    # False = pure score ranking (rerank mode), no MMR diversification
    diversify: bool = True


class ChainReceiptRequest(SettleRequest):
    z_th: float = 2.5


class BatchSettleRequest(BaseModel):
    """One corpus, many queries — served by the vmapped batched solver."""

    Y: list[list[float]] = Field(..., description="Matrix N x D (shared corpus)")
    psis: list[list[float]] = Field(..., description="Q query vectors [Q x D]")
    gates_batch: Optional[list[list[float]]] = None  # [Q x N]
    params: Params = Params()
    bundle_k: int = 8
    alpha: float = 0.5
    # Q screened-Poisson solves over the shared graph, vmapped
    # (lattice.diffusion_gates_batch); mutually exclusive with gates_batch
    diffusion: Optional[DiffusionOptions] = None


class RaggedBundleRequest(BaseModel):
    """Many corpora of different sizes — one padded vmapped batch."""

    corpora: list[list[list[float]]] = Field(
        ..., description="B corpora, each N_i x D (shared D)"
    )
    psis: list[list[float]] = Field(..., description="B query vectors [B x D]")
    gates: Optional[list[Optional[list[float]]]] = None  # per corpus, len N_i
    params: Params = Params()
    bundle_k: int = 8
    alpha: float = 0.5
    options: SettleOptions = SettleOptions()
    # declared so a request carrying it gets an explicit 422 (see
    # BatchSettleRequest) instead of a silent drop
    diffusion: Optional[DiffusionOptions] = None


class AutoCorrectRequest(BaseModel):
    text: str
    preserve: Optional[list[str]] = None


class CompetitorBenchRequest(BaseModel):
    texts: list[str]
    query: Optional[str] = None
    query_index: Optional[int] = None
    labels: Optional[list[int]] = None
    traps: Optional[list[int]] = None
    k: int = 5
    kneighbors: int = 6
    lamG: float = 1.0
    lamC: float = 0.5
    lamQ: float = 4.0
    tune: bool = False
    tune_trials: int = 8
    smart_correct: bool = False


class AdminKeyUpdate(BaseModel):
    tier: Optional[str] = None
    status: Optional[str] = None
    quota_limit_units: Optional[int] = None
    quota_window_seconds: Optional[int] = None
    features: Optional[dict[str, bool]] = None
