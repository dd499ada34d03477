"""The whole step: model FLOPs of the work completed in the window
(prefills and decode tokens, causal attention over each token's context,
the sketched head's FLOPs a decode token; ``work.py``) over the window's
seconds at the card's bf16 peak, in %."""

from perfbench import work


def read(w):
    flops = sum(w.model_flops().values())
    if not flops:
        return None
    return 100.0 * flops / (w.seconds * work.PEAK_BF16)
