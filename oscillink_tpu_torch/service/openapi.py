"""The service's OpenAPI schema, built from this package's route table and
request models (the port of ``scripts/export_openapi.py:build_schema``,
which imports the JAX package and so cannot serve the port's
``/openapi.json``)."""

from __future__ import annotations

__all__ = ["build_schema"]


def build_schema() -> dict:
    from .. import __version__
    from . import api
    from .models import AutoCorrectRequest, CompetitorBenchRequest, SettleRequest

    paths: dict[str, dict] = {}
    for method, regex, handler in api._ROUTES:
        # reconstruct the template from the compiled pattern
        template = regex.pattern[1:-1]
        template = template.replace("(?P<", "{").replace(">[^/]+)", "}")
        doc = (handler.__doc__ or "").strip().splitlines()
        summary = doc[0] if doc else handler.__name__
        paths.setdefault(template, {})[method.lower()] = {
            "summary": summary,
            "operationId": handler.__name__,
        }
    return {
        "openapi": "3.1.0",
        "info": {"title": "oscillink-tpu cloud", "version": __version__},
        "paths": paths,
        "components": {
            "schemas": {
                "SettleRequest": SettleRequest.model_json_schema(),
                "AutoCorrectRequest": AutoCorrectRequest.model_json_schema(),
                "CompetitorBenchRequest": CompetitorBenchRequest.model_json_schema(),
            }
        },
    }
