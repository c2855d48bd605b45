"""The repo's five example scripts on the port, one module each, under the
same names: ``python -m repro_torch.examples.<name>``.

- :mod:`quickstart`     Theorem 2 against Monte Carlo, eq. 16 against LRU
                        and VA-CDH on a synthetic Zipf trace, the latency
                        laws beyond the paper
- :mod:`trace_sim`      the §5 policy comparison on a trace surrogate
- :mod:`hierarchy_sim`  four L1 edge shards over a shared L2, and the
                        hierarchy grid over the L2's capacity
- :mod:`serve_engine`   a smoke-scale LM behind the continuous batcher,
                        and a policy A/B on the prefix cache
- :mod:`train_small`    a ~100M-parameter LM trained with the ``Trainer``

Each takes the flags of its script plus ``--device`` (without it the run
is on the card and raises if there is none), and its ``run(...,
device=None, use_kernel=None)`` returns every number it prints;
``use_kernel="ref"`` runs the plain version of every kernel.
``python -m repro_torch.examples`` runs all five at their default sizes,
one process each, timed (:mod:`.__main__`).
"""


def result_row(r) -> dict:
    """A :class:`repro_torch.core.SimResult`'s totals as Python numbers."""
    return dict(total_latency=float(r.total_latency),
                hit_ratio=float(r.hit_ratio), n_hits=int(r.n_hits),
                n_delayed=int(r.n_delayed), n_misses=int(r.n_misses),
                n_evictions=int(r.n_evictions))
