"""Prefill: ms per 1000 prompt tokens, the benchmark's synchronised spans
around every ``EngineBackend.prefill`` and ``insert`` of the window over
the prompt tokens those prefills took."""


def read(w):
    pre = [s for s in w.spans if s[0] == "prefill"]
    tokens = sum(g * p for _, _, _, (g, p) in pre)
    if not tokens:
        return None
    busy = sum(s[2] - s[1] for s in w.spans if s[0] in ("prefill", "insert"))
    return 1e3 * busy / (tokens / 1000.0)
