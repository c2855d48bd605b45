"""Tiny configurations and traffic for the CPU tests: the benchmark's
cells' equations at widths a test run holds."""
import copy

from perfbench import harness

TRAIN_OPT = {"lr": 3e-4, "warmup_steps": 1, "total_steps": 100,
             "min_lr_frac": 0.1, "b1": 0.9, "b2": 0.95, "eps": 1e-8,
             "weight_decay": 0.1, "clip_norm": 1.0}
PREFILL = {"entry": "prefill", "capacity": 64,
           "lengths": {"levels": [[16, 16], [64, 64], [32, 32], [64, 64]],
                       "per_level": 1, "mix_seed": 1}}
TRAIN = {"entry": "train", "rows": 2, "seq_len": 32, "batches": 4,
         "opt": TRAIN_OPT}


def config(registry: str = "starcoder2-15b", window: int | None = 32,
           mlp: str = "gelu_tanh", dtype: str = "float32") -> dict:
    """A 2-layer model of ``registry``'s family at width 64, in float32 by
    default: bf16 rounding at this width reads far above the full-size
    readings that the cells' limits were set from, so the tests judge a
    float32 program by them (the card's runs judge the bf16 one)."""
    return {"name": f"tiny-{registry}", "reference": "dense",
            "hidden_size": 64, "intermediate_size": 128,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "head_dim": 16, "num_hidden_layers": 2, "vocab_size": 256,
            "rope_theta": 100000, "sliding_window": window,
            "as_run": {"registry": registry,
                       "port_fields": {"n_layers": 2, "d_model": 64,
                                       "n_heads": 4, "n_kv_heads": 2,
                                       "d_head": 16, "d_ff": 128,
                                       "vocab": 256,
                                       "sliding_window": window or 0,
                                       "dtype": dtype},
                       "dtype": dtype, "mlp": mlp, "norm": "rms_norm",
                       "norm_eps": 1e-5, "bias": False,
                       "rope_scaling": None}}


STARCODER = dict(registry="starcoder2-15b", window=32, mlp="gelu_tanh")
DEEPSEEK = dict(registry="deepseek-coder-33b", window=None, mlp="swiglu")


def cell(workload: str, **cfg) -> harness.Cell:
    """``workload``'s cell of BENCHMARK.json with a tiny configuration and
    traffic of its kind, and the cell's own limits."""
    real = harness.load_cell(workload)
    kind = real.traffic["entry"]
    c = copy.copy(real)
    c.config = config(**cfg)
    c.traffic = copy.deepcopy(PREFILL if kind == "prefill" else TRAIN)
    return c
