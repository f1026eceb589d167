"""service.parse_pct: the share of the requests' host time that the service
spends parsing them (JSON decode, pydantic validation, the payload's
conversion to arrays), each step wrapped from the harness."""


def read(run):
    parse, total = run.counters.get("parse_s"), run.spans.get("request")
    if not parse or not total:
        return None
    return 100.0 * sum(parse) / sum(total)
