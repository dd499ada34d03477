"""Decode loop: ms a decode step, the benchmark's spans around every
``EngineBackend.megastep`` of the window (each ends in its copy to the
host) over the steps they ran."""


def read(w):
    spans = [s for s in w.spans if s[0] == "megastep"]
    steps = sum(s[3][0] for s in spans)
    if not steps:
        return None
    return 1e3 * sum(s[2] - s[1] for s in spans) / steps
