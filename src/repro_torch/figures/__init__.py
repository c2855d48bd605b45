"""The paper's figure drivers on the port (fig2-fig5), and fig6 (the
hierarchy, beyond the paper).

    python3 -m repro_torch.figures.run --only fig2,fig4 [--device cpu]

Each driver's ``run()`` returns rows in the JAX package's schema
(``benchmarks/``); CSVs go to ``repro_torch/figures/results/``.
"""
