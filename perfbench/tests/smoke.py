"""Smoke-size cells for the CPU tests: the two backbones at the port's
smoke widths, the cells' head recipe, and small mixes of each loop."""

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)

from perfbench import traffic  # noqa: E402

HEAD = {"kind": "sketch", "n_rows": 128, "n_buckets": 16, "k": 1,
        "proj_dim": 32, "bandwidth": 2.0, "counts": "float32",
        "n_anchors": 256, "alpha_scale": 0.1}

MODELS = {
    "rwkv": ("rwkv6-1.6b", {"kind": "rwkv", "n_layers": 2, "d_model": 64,
                            "d_ff": 128, "head_size": 64, "vocab_size": 256,
                            "tie_embeddings": False, "norm_eps": 1e-5}),
    "attn": ("command-r-35b", {"kind": "attn", "n_layers": 2, "d_model": 64,
                               "d_ff": 128, "vocab_size": 256,
                               "tie_embeddings": True, "norm_eps": 1e-5,
                               "attention": {"n_heads": 4, "n_kv_heads": 2,
                                             "head_dim": 16,
                                             "rope_theta": 10000.0}}),
}

E2E = ("out_tok_s", "ttft_mean_ms", "tpot_p95_ms", "prompt_tok_s", "setup_s")
PER_LAYER = ("slot_util.decode", "decode_step_ms.decode",
             "prefill_ms_per_ktok.chat", "mfu.decode",
             "fused_decode_roofline.decode", "flash_attn_roofline.chat",
             "device_idle.decode")


# The check's limits at smoke size, set from smoke runs as the cells' are
# from theirs: above what sound runs read (decode_gap_mean <= 0.006, share
# over 0.05 <= 0.021), below the float8 control (>= 0.034, >= 0.28).
LIMITS = {"decode_gap_mean": 0.02, "decode_share_over_0.05": 0.1}


def committed_limits() -> dict:
    """Each committed cell's limits file (``limits/<workload>.json``) by
    the kind of its configuration's model."""
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    files = {c["name"]: c["file"] for c in bench["configs"]}
    out: dict = {}
    for w in bench["workloads"]:
        kind = json.loads((ROOT / files[w["config"]]).read_text())[
            "model"]["kind"]
        names = json.loads((ROOT / "perfbench" / "limits" /
                            f"{w['name']}.json").read_text())
        out.setdefault(kind, {}).update(names)
    return out


def limits(kind: str) -> dict:
    """Smoke limits on the numbers the committed cells of this kind of
    model compare; every number, for a kind no committed cell has."""
    names = committed_limits().get(kind, LIMITS)
    return {name: LIMITS[name] for name in names}


def mix_spec(loop="closed", tenants=None):
    spec = {"loop": loop, "clients": 4, "rate": 4.0, "warm_s": 0.3,
            "n_slots": 4, "max_seq": 64, "decode_chunk": 4,
            "prompt": {"dist": "loguniform", "lo": 4, "hi": 16},
            "output": {"dist": "uniform", "lo": 8, "hi": 24},
            "check": {"requests": 3}}
    if tenants:
        spec["tenants"] = {"n": tenants, "zipf_s": 1.1, "capacity": tenants}
    return spec


def cell(kind="rwkv", loop="closed", tenants=None, limits=None):
    arch, model = MODELS[kind]
    return {"cell": {"name": f"smoke-{kind}", "chips": 1},
            "cfg": {"arch": arch, "smoke": True, "model": model,
                    "head": dict(HEAD)},
            "mix": traffic.Mix("smoke", mix_spec(loop, tenants)),
            "limits": limits,
            "end_to_end": [{"name": n, "unit": "x"} for n in E2E],
            "per_layer": [{"name": n, "unit": "x"} for n in PER_LAYER]}
