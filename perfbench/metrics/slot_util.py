"""Engine: the share of slot-steps that decoded a live request over the
window (``ServeEngine.stats``: Δactive_slot_steps / (Δdecode_steps ×
n_slots)), in %."""


def read(w):
    steps = w.stats.get("decode_steps", 0)
    if not steps:
        return None
    return 100.0 * w.stats["active_slot_steps"] / (steps * w.mix.n_slots)
