"""Cloud service layer of the PyTorch port: ``oscillink_tpu/service``
served by the port's lattice on the card (``cuda`` unless `create_state`
is given another device), the equivalent of the reference's FastAPI app
(cloud/app/, ~4.5 kLoC) re-designed as a framework-free core.

Architecture:
  * `api.py` — pure handlers over (ServiceState, ApiRequest) -> ApiResponse;
    no web framework in the compute path, trivially testable in-process;
  * `http.py` — thin aiohttp binding with the reference's middleware stack
    (body-size guard, request id, security headers, access log, rate limits);
  * governance (keystore / tiers / quotas / monthly caps), metrics, usage
    logging, async jobs, bundle cache, adaptive learners, Stripe webhooks and
    CLI pairing live in their own modules.

Endpoint surface mirrors openapi_baseline.json (`openapi.py` builds the
schema from this package's own route table and models): /health, /license/status,
/metrics, /v1/{settle,receipt,bundle,chain/receipt,autocorrect,
bench/competitor}, /v1/jobs/*, /stripe/webhook, /billing/*, /admin/*.
"""

from .api import ServiceState, create_state, handle  # noqa: F401
from .testing import LocalClient  # noqa: F401
