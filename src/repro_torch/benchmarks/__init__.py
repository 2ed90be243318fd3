"""The paper's benches on the port: ``fig6_switching`` (continual
training across mode switches, and the switching harness's trajectory)
and ``autoswitch`` (the adaptive controller on the cluster simulator).
Each prints the JAX package's CSV rows, ``name,us_per_call,derived``."""


def csv_row(name: str, us_per_call: float, derived: str) -> str:
    """One CSV row, as ``benchmarks.common.csv_row`` writes it."""
    return f"{name},{us_per_call:.1f},{derived}"
