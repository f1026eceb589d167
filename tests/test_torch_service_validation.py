"""Invalid payloads: the port's service and the JAX service give the same
status and the same detail (for a 422, the failing field's location with
pydantic's message) on each row of the table, before any lattice is built
or any quota is charged."""

import json
import os
import random

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from oscillink_tpu.service import LocalClient as JaxClient  # noqa: E402
from oscillink_tpu.service import config as jax_config  # noqa: E402
from oscillink_tpu.service.api import create_state as jax_create_state  # noqa: E402
from oscillink_tpu_torch.service import LocalClient  # noqa: E402
from oscillink_tpu_torch.service import config as port_config  # noqa: E402
from oscillink_tpu_torch.service.api import create_state  # noqa: E402

_rng = np.random.default_rng(0)
Y = _rng.standard_normal((12, 4)).astype(np.float32).round(3).tolist()
PSI = [0.5, -0.25, 1.0, 0.0]
OK = {"Y": Y, "psi": PSI}


def _with(**kw):
    return {**OK, **kw}


def _nested(section, **kw):
    return {**OK, section: kw}


ROWS = [
    # (id, path, body: dict to serialize, or raw bytes)
    ("empty_Y", "/v1/settle", {"Y": []}),
    ("empty_rows", "/v1/settle", {"Y": [[], []]}),
    ("missing_Y", "/v1/settle", {"psi": PSI}),
    ("Y_not_a_list", "/v1/settle", {"Y": "abc"}),
    ("Y_row_not_a_list", "/v1/settle", {"Y": [1.0, 2.0]}),
    ("Y_word_element", "/v1/settle", {"Y": [["a", 1.0], [2.0, 3.0]]}),
    ("Y_null_element", "/v1/settle", {"Y": [[None, 1.0], [2.0, 3.0]]}),
    ("Y_numeric_strings", "/v1/settle", {"Y": [["1.5", "2"], ["0.5", "-1"], ["3", "1e-2"]]}),
    ("Y_bools", "/v1/settle", {"Y": [[True, False], [False, True], [True, True]]}),
    ("Y_ragged_rows", "/v1/settle", {"Y": [[1.0, 2.0], [3.0]]}),
    ("psi_wrong_length", "/v1/settle", _with(psi=[1.0, 2.0])),
    ("psi_word", "/v1/settle", _with(psi=["x", 1.0, 2.0, 3.0])),
    ("gates_wrong_length", "/v1/settle", _with(gates=[1.0, 1.0])),
    ("chain_one_node", "/v1/settle", _with(chain=[3])),
    ("chain_out_of_bounds", "/v1/settle", _with(chain=[0, 12])),
    ("chain_negative", "/v1/settle", _with(chain=[-1, 2])),
    ("chain_floats", "/v1/settle", _with(chain=[0.5, 2])),
    ("lamG_zero", "/v1/settle", _nested("params", lamG=0.0)),
    ("lamC_negative", "/v1/settle", _nested("params", lamC=-0.1)),
    ("lamQ_negative", "/v1/settle", _nested("params", lamQ=-1.0)),
    ("lamP_negative", "/v1/settle", _nested("params", lamP=-1.0)),
    ("kneighbors_zero", "/v1/settle", _nested("params", kneighbors=0)),
    ("kneighbors_string", "/v1/settle", _nested("params", kneighbors="six")),
    ("kneighbors_float", "/v1/settle", _nested("params", kneighbors=2.5)),
    ("kneighbors_numeric_string", "/v1/settle", _nested("params", kneighbors="3")),
    ("deterministic_k_word", "/v1/settle", _nested("params", deterministic_k="maybe")),
    ("similarity_unknown", "/v1/settle", _nested("params", similarity="approximate")),
    ("max_iters_zero", "/v1/settle", _nested("options", max_iters=0)),
    ("max_iters_above_bound", "/v1/settle", _nested("options", max_iters=10_001)),
    ("tol_zero", "/v1/settle", _nested("options", tol=0.0)),
    ("dt_negative", "/v1/settle", _nested("options", dt=-1.0)),
    ("bundle_k_negative", "/v1/settle", _nested("options", bundle_k=-1)),
    ("include_receipt_word", "/v1/settle", _nested("options", include_receipt="sometimes")),
    ("params_not_an_object", "/v1/settle", _with(params=[1, 2])),
    ("diffusion_gamma_zero", "/v1/settle", _nested("diffusion", gamma=0.0)),
    ("diffusion_max_iters_zero", "/v1/settle", _nested("diffusion", max_iters=0)),
    ("extra_keys_ignored", "/v1/settle", _with(unknown_key=1, options={"unknown": 2})),
    ("bad_json", "/v1/settle", b"{not json"),
    ("json_array_body", "/v1/settle", b"[1, 2, 3]"),
    ("bundle_k_word", "/v1/bundle", _with(bundle_k="eight")),
    ("chain_receipt_without_chain", "/v1/chain/receipt", OK),
    ("chain_receipt_z_th_word", "/v1/chain/receipt", _with(chain=[0, 1], z_th="high")),
    ("batch_psis_wrong_width", "/v1/settle/batch", {"Y": Y, "psis": [[1.0, 2.0]]}),
    ("batch_psis_empty", "/v1/settle/batch", {"Y": Y, "psis": []}),
    ("batch_missing_psis", "/v1/settle/batch", {"Y": Y}),
    ("batch_gates_shape", "/v1/settle/batch", {"Y": Y, "psis": [PSI], "gates_batch": [[1.0]]}),
    ("ragged_empty", "/v1/bundle/ragged", {"corpora": [], "psis": []}),
    ("ragged_psis_count", "/v1/bundle/ragged", {"corpora": [Y], "psis": []}),
    ("ragged_d_mismatch", "/v1/bundle/ragged",
     {"corpora": [Y, [[1.0, 2.0], [3.0, 4.0]]], "psis": [PSI, [1.0, 2.0]]}),
    ("ragged_empty_corpus", "/v1/bundle/ragged", {"corpora": [[]], "psis": [PSI]}),
    ("ragged_rows", "/v1/bundle/ragged", {"corpora": [[[1.0, 2.0], [3.0]]], "psis": [[1.0, 2.0]]}),
    ("ragged_diffusion", "/v1/bundle/ragged", {"corpora": [Y], "psis": [PSI], "diffusion": {}}),
    ("autocorrect_missing_text", "/v1/autocorrect", {"preserve": ["x"]}),
    ("bench_texts_empty", "/v1/bench/competitor", {"texts": []}),
    ("jobs_bad_options", "/v1/jobs/settle", _nested("options", tol=-1.0)),
]


# the JAX service's status on each row (200: coerced or ignored input, served)
SERVED = {"Y_numeric_strings", "Y_bools", "kneighbors_numeric_string", "extra_keys_ignored"}
BAD_REQUEST = {
    "empty_Y", "empty_rows", "Y_ragged_rows", "psi_wrong_length", "gates_wrong_length",
    "chain_one_node", "chain_out_of_bounds", "chain_negative", "bad_json",
    "chain_receipt_without_chain", "batch_psis_wrong_width", "batch_psis_empty",
    "batch_gates_shape", "ragged_empty", "ragged_psis_count", "ragged_d_mismatch",
    "ragged_empty_corpus", "ragged_rows", "bench_texts_empty",
}


def _expected(row_id):
    return 200 if row_id in SERVED else 400 if row_id in BAD_REQUEST else 422


@pytest.fixture(scope="module")
def clients():
    """Both services with no OSCILLINK_ setting but the diffusion feature on
    (open access is the free tier), so gates and diffusion blocks reach
    their validation instead of the tier gate's 403."""
    saved = {k: os.environ.pop(k) for k in list(os.environ) if k.startswith("OSCILLINK_")}
    os.environ["OSCILLINK_FEAT_DIFFUSION_GATES"] = "1"
    port_config.get_settings.cache_clear()
    jax_config.get_settings.cache_clear()
    try:
        yield LocalClient(create_state(device="cpu")), JaxClient(jax_create_state())
    finally:
        del os.environ["OSCILLINK_FEAT_DIFFUSION_GATES"]
        os.environ.update(saved)


@pytest.mark.parametrize("row_id,path,body", ROWS, ids=[r[0] for r in ROWS])
def test_invalid_payload_gets_the_jax_status_and_detail(clients, row_id, path, body):
    port, jax = clients
    data = body if isinstance(body, bytes) else json.dumps(body).encode()
    random.seed(0)
    rj = jax.request("POST", path, data=data)
    random.seed(0)
    rp = port.request("POST", path, data=data)
    assert rj.status_code == _expected(row_id), rj.json()
    assert rp.status_code == rj.status_code, (rp.json(), rj.json())
    if rj.status_code >= 400:
        assert rp.json() == rj.json()
    else:  # coerced or ignored input: both served it
        assert rp.json().get("state_sig") == rj.json().get("state_sig")
