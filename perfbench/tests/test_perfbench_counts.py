"""The benchmark's counts against hand-worked values at tiny shapes, and
the trace arithmetic (busy union, idle gaps, their labels)."""
import pytest

from perfbench import trace, yardstick as ys

G = dict(d=8, h=4, kv=2, dh=2, layers=3, vocab=10, window=0,
         matrix_params=448, head_params=80)
PEAK = {"bf16_flops": 1e12, "hbm_bytes_s": 1e9}


@pytest.mark.parametrize("s,window,want", [
    (1, 0, 1), (4, 0, 10), (5, 0, 15),       # causal: 1+2+...+s
    (5, 2, 9),                                # 1, 2, 2, 2, 2
    (5, 5, 15), (5, 9, 15),                   # a window >= s is causal
    (6, 3, 15),                               # 1, 2, 3, 3, 3, 3
])
def test_visible_pairs(s, window, want):
    assert ys.visible_pairs(s, window) == want


def _dense_cfg(mlp):
    return {"reference": "dense", "hidden_size": 8, "intermediate_size": 16,
            "num_attention_heads": 4, "num_key_value_heads": 2,
            "head_dim": 2, "num_hidden_layers": 3, "vocab_size": 10,
            "sliding_window": None, "as_run": {"mlp": mlp}}


@pytest.mark.parametrize("mlp,matrix", [
    # q, o: 8 x (4*2) each; k, v: 8 x (2*2) each; MLP up, down 8 x 16
    ("gelu_tanh", 64 + 64 + 32 + 32 + 256),
    ("swiglu", 192 + 3 * 128),               # and a gate 8 x 16
])
def test_dense_geometry(mlp, matrix):
    g = ys.geometry(_dense_cfg(mlp))
    assert g == dict(d=8, h=4, kv=2, dh=2, layers=3, vocab=10, window=0,
                     matrix_params=matrix, head_params=80)


def test_prefill_flops_counts_the_head_once():
    s = 4
    # 2 x 448 x 3 layers x 4 tokens + 4 x 10 pairs x 2 x 4 heads x 3 layers
    # + the head at the last position, 2 x 8 x 10
    assert ys.prefill_flops(G, s) == 2 * 448 * 3 * 4 + 4 * 10 * 2 * 4 * 3 \
        + 2 * 8 * 10


def test_prefill_flops_with_window():
    g = dict(G, window=2)
    assert ys.prefill_flops(g, 5) == 2 * 448 * 3 * 5 + 4 * 9 * 2 * 4 * 3 \
        + 160


def test_train_flops():
    # 6 x (3 x 448 + 80) x 2 rows x 4 + 12 x 3 layers x (2 x 10 pairs) x 2 x 4
    assert ys.train_flops(G, 2, 4) == 6 * (3 * 448 + 80) * 8 \
        + 12 * 3 * 20 * 2 * 4


def test_attention_bound_operations_and_bytes():
    secs, by = ys.attention_bound(G, 1, 4, PEAK)
    flops = 4 * 10 * 4 * 2                  # 4 x pairs x heads x d_head
    nbytes = (2 * 4 * 4 + 2 * 4 * 2) * 2 * 2 + 2 * 4 * 4
    assert by == "bytes" and secs == pytest.approx(nbytes / 1e9)
    secs, by = ys.attention_bound(G, 1, 4, {"bf16_flops": 1.0,
                                            "hbm_bytes_s": 1e12})
    assert by == "operations" and secs == pytest.approx(flops)


def test_derive_is_stable_and_distinct():
    big = 2 ** 31 + 12345
    assert ys.derive(big, "x", 1) == ys.derive(big, "x", 1)
    assert ys.derive(big, "x", 1) != ys.derive(big, "x", 2)
    assert 0 <= ys.derive(big, "x") < 2 ** 63


def test_trace_busy_gaps_and_labels():
    dev = [("k1", 1.0, 2.0), ("k2", 1.5, 3.0), ("copy", 5.0, 6.0),
           ("late", 9.5, 11.0)]
    host = [("bench.window", 0.0, 10.0), ("bench.read_token", 3.0, 5.0),
            ("aten::item", 3.5, 4.5), ("bench.prefill_step", 6.0, 9.0)]
    tr = trace.build((0.0, 10.0), dev, host)
    assert tr.busy_s == pytest.approx(2.0 + 1.0 + 0.5)
    assert tr.gaps == [(0.0, 1.0), (3.0, 5.0), (6.0, 9.5)]
    bd = trace.breakdown(tr)
    assert bd["idle_gaps"][0] == ["bench.prefill_step", 3.5]
    assert bd["idle_gaps"][1] == ["aten::item", 2.0]
    assert bd["idle_gaps"][2] == ["idle host", 1.0]
    assert bd["device_ops"][0] == ["k2", 1.5]


class _Event:
    """A profiler event as ``_KinetoEvent`` shows one."""

    def __init__(self, name, start, end, device="DeviceType.CUDA",
                 annotation=False):
        self._v = (name, int(start * 1e9), int(end * 1e9), device,
                   annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def end_ns(self):
        return self._v[2]

    def device_type(self):
        return self._v[3]

    def is_user_annotation(self):
        return self._v[4]


class _Profile:
    def __init__(self, events):
        results = type("R", (), {"events": lambda self: events})()
        self.profiler = type("P", (), {"kineto_results": results})()


def test_from_profiler_counts_the_cards_work_only():
    """Kernels, copies and sets off the host are busy time; the device-side
    copies of user spans and the sync markers are not; host events are
    the host's.  Times run from the window's start and are clipped to
    it."""
    cpu = "DeviceType.CPU"
    events = [
        _Event("bench.window", 10.0, 14.0, cpu),
        _Event("bench.prefill_step", 10.5, 11.5, cpu),
        _Event("flash_mma_kernel", 11.0, 12.0),
        _Event("Memcpy DtoH (Device -> Pinned)", 12.5, 13.0),
        _Event("Memset (Device)", 9.0, 10.25),
        _Event("bench.prefill_step", 10.5, 13.8, annotation=True),
        _Event("Event Sync", 13.0, 13.9),
        _Event("Stream Wait Event", 13.0, 13.9),
    ]
    tr = trace.from_profiler(_Profile(events))
    assert tr.window_s == pytest.approx(4.0)
    assert [n for n, _, _ in tr.device] == [
        "Memset (Device)", "flash_mma_kernel",
        "Memcpy DtoH (Device -> Pinned)"]
    assert tr.busy_s == pytest.approx(0.25 + 1.0 + 0.5)
    assert trace.host_at(tr, 0.75) == "bench.prefill_step"
    assert trace.host_at(tr, 3.5) == "idle host"
