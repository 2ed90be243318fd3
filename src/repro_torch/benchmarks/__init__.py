"""The paper's benches on the port: ``fig6_switching`` (continual
training across mode switches, and the switching harness's trajectory),
``multitask`` (claim C2 on DIEN and YouTubeDNN), ``decay_ablation``,
``fig3_grad_distribution``, ``fig78_batch_ablation``, ``convergence``
(Theorems 1/2), ``tab52_qps`` (the simulated Tab. 5.2/5.3 QPS, staleness
and drops) and ``autoswitch`` (the adaptive controller on the cluster
simulator).  Each prints the JAX package's CSV rows,
``name,us_per_call,derived``; the model benches start from the
reference's initial draw (``repro_torch.convert.jax_init_recsys``)."""


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    """One CSV row, as ``benchmarks.common.csv_row`` writes it."""
    return f"{name},{us_per_call:.1f},{derived}"
