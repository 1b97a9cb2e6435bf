"""The 95th percentile of every gap between a request's consecutive tokens
landing in the window, in ms: ``itl_p95_ms`` itself, read where its
run-to-run spread is wider than an end-to-end bound can be (PERF.md)."""


def read(rec):
    if rec.kind != "serve":
        return None
    return rec.extras.get("itl_p95_ms")
