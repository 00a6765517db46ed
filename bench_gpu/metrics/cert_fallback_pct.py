"""cert_fallback_pct: of the queries the certified tier served in the
window, the share it served again on the exact tier (ops/scan.py
CERT_STATS fallback_queries over queries, read as differences), in
percent."""


def read(run):
    q = run.counters.get("cert_queries", 0)
    if q <= 0:
        return None
    return 100.0 * run.counters.get("cert_fallback_queries", 0) / q
