"""Core of the port: the paper's delayed-hit caching technique in PyTorch.

- :mod:`delay_stats`   Theorem 1 & 2 moments + Monte-Carlo oracle
- :mod:`distributions` miss-latency laws (Deterministic / Exponential /
                       Erlang / Hyperexponential / Monte Carlo)
- :mod:`ranking`       eq. 16 ranking + every §5.1 baseline
- :mod:`state`         dense ``[L, N]`` simulator state
- :mod:`trace`         trace schema, host request streams
- :mod:`simulator`     ``simulate`` / ``latency_improvement`` /
                       ``simulate_stream`` / ``simulate_chunked``
- :mod:`hierarchy`     the two-tier L1-shards + L2 hierarchy
                       (``simulate_hier``, ``simulate_hier_chunked``)
- :mod:`refsim`        the event-driven oracle (numpy, tests only)
- :mod:`sweep`         ``sweep_grid`` over traces x policies x params x
                       capacities x seeds, and ``sweep_hier_grid``
"""
from .delay_stats import (agg_mean_from_moments, agg_var_from_moments,
                          det_mean, det_var, stoch_mean, stoch_std, stoch_var)
from .distributions import (DISTRIBUTIONS, Deterministic, Erlang, Exponential,
                            Hyperexponential, MissLatency, MonteCarlo,
                            make_distribution)
from .ranking import (BASELINES, OURS, POLICIES, Policy, PolicyParams,
                      Substrate, make_substrate)
from .hierarchy import (HierResult, HierTrace, make_hier_trace,
                        simulate_hier, simulate_hier_chunked)
from .simulator import (EVICT_TOP, SimResult, latency_improvement,
                        resolve_chunk_size, resolve_score_mode, simulate,
                        simulate_chunked, simulate_stream)
from .state import (ObjStats, SimState, SlotState, SlotView, init_slot_state,
                    init_state, slot_table_size)
from .sweep import HierSweepGrid, SweepGrid, sweep_grid, sweep_hier_grid
from .trace import (RequestStream, Trace, auto_chunk_size, make_trace,
                    stream_of_trace, trace_of_stream)

__all__ = [
    "agg_mean_from_moments", "agg_var_from_moments",
    "det_mean", "det_var", "stoch_mean", "stoch_std", "stoch_var",
    "DISTRIBUTIONS", "Deterministic", "Erlang", "Exponential",
    "Hyperexponential", "MissLatency", "MonteCarlo", "make_distribution",
    "BASELINES", "OURS", "POLICIES", "Policy", "PolicyParams",
    "Substrate", "make_substrate",
    "EVICT_TOP", "SimResult", "latency_improvement", "resolve_chunk_size",
    "resolve_score_mode", "simulate", "simulate_chunked", "simulate_stream",
    "HierResult", "HierTrace", "make_hier_trace", "simulate_hier",
    "simulate_hier_chunked",
    "ObjStats", "SimState", "SlotState", "SlotView", "init_slot_state",
    "init_state", "slot_table_size",
    "HierSweepGrid", "SweepGrid", "sweep_grid", "sweep_hier_grid",
    "RequestStream", "Trace", "auto_chunk_size", "make_trace",
    "stream_of_trace", "trace_of_stream",
]
