"""Requests a merged evaluation of the device service: its
``pintron_service_request`` spans over its ``pintron_service_eval``
spans (``devservice.serve``: one eval span a merged batch of one op,
one request span a client's batch in it), in the traced window.  1
where the service merged nothing."""


def read(ctx):
    spans = ctx["spans"].get("service") or []
    evals = sum(1 for s in spans if s.name == "pintron_service_eval")
    requests = sum(1 for s in spans if s.name == "pintron_service_request")
    return requests / evals if evals else None
