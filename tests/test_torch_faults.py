"""The port's fault plans (``repro_torch.sim.faults``) against the JAX
package's (``repro.sim.faults``), on the CPU.

Each case of ``tests/test_faults.py`` runs once on each package's classes
with the same inputs and records what it sees: validation errors, plan
fields, slowdowns, durations, crash events and times, down windows,
scrapes and apply failures.  The two records must be equal, value for
value: both packages draw from numpy in the same order.
"""
import dataclasses

import numpy as np
import pytest

import repro.sim.cluster as jax_cluster
import repro.sim.faults as jax_faults
import repro_torch.sim.cluster as torch_cluster
import repro_torch.sim.faults as torch_faults

PACKAGES = {"reference": jax_faults, "port": torch_faults}


def _plain(x):
    """A record value free of either package's classes."""
    if dataclasses.is_dataclass(x):
        return (type(x).__name__, _plain(dataclasses.astuple(x)))
    if isinstance(x, (tuple, list)):
        return tuple(_plain(v) for v in x)
    if isinstance(x, np.ndarray):
        return tuple(x.tolist())
    if isinstance(x, (np.floating, np.integer, np.bool_)):
        return x.item()
    return x


def _raises(fn):
    try:
        fn()
    except ValueError:
        return "ValueError"
    return "no error"


def case_validation(P):
    return [_raises(f) for f in (
        lambda: P.StragglerWindow(worker=-1),
        lambda: P.StragglerWindow(worker=0, slowdown=0.0),
        lambda: P.StragglerWindow(worker=0, start=5.0, end=1.0),
        lambda: P.CrashEvent(worker=0, at=1.0, recovery=-1.0),
        lambda: P.ScrapeDropout(start=3.0, end=1.0),
        lambda: P.FaultPlan(num_workers=0),
        lambda: P.FaultPlan(2, stragglers=(P.StragglerWindow(worker=5),)),
        lambda: P.FaultPlan(2, crashes=(P.CrashEvent(worker=2, at=1.0),)),
        lambda: P.FaultPlan(2, crashes=(P.CrashEvent(worker=1, at=1.0),)),
    )]


def case_crashes_sorted(P):
    p = P.FaultPlan(4, crashes=(P.CrashEvent(1, 9.0), P.CrashEvent(0, 2.0),
                                P.CrashEvent(2, 5.0), P.CrashEvent(0, 5.0)))
    return _plain(p.crashes)


def case_slowdown_windows(P):
    p = P.FaultPlan(4, stragglers=(
        P.StragglerWindow(1, 4.0),
        P.StragglerWindow(1, 2.0, start=10.0, end=20.0),
        P.StragglerWindow(2, 3.0, start=0.0, end=5.0)))
    return ([p.slowdown(w, t) for w in range(4)
             for t in (0.0, 1.0, 4.9, 5.0, 10.0, 15.0, 20.0)],
            p.straggler_workers())


def case_scrape_dropout(P):
    p = P.FaultPlan(2, dropouts=(P.ScrapeDropout(1.0, 2.0),))
    return [p.scrape_lost(t) for t in (0.5, 1.0, 1.99, 2.0)]


def case_strained(P):
    return [_plain(P.FaultPlan.strained(n, seed=s, crash_at=at))
            for n in (1, 4, 8, 16) for s in (0, 3) for at in (None, 1.0)]


def case_from_cluster_spec(P):
    out = []
    for seed, rate, frac in ((5, 0.02, 0.25), (1, 0.0, 0.0), (7, 0.1, 0.5)):
        spec = P.ClusterSpec(num_workers=8, straggler_frac=frac,
                             straggler_slowdown=4.0, failure_rate=rate,
                             recovery_time=3.0, seed=seed)
        out.append(_plain(P.FaultPlan.from_cluster_spec(spec, 200.0)))
    return out


def _quiet_spec(P, n=4, jitter=0.0):
    return P.ClusterSpec(num_workers=n, base_speed=1000.0, jitter=jitter,
                         straggler_frac=0.0, seed=0)


def case_injector_mismatch(P):
    return _raises(lambda: P.FaultInjector(P.FaultPlan.quiet(4),
                                           _quiet_spec(P, 2)))


def case_injector_durations(P):
    plan = P.FaultPlan(4, stragglers=(P.StragglerWindow(1, 4.0),
                                      P.StragglerWindow(3, 2.0, 1.0, 2.0)))
    out = []
    for jitter in (0.0, 0.2):
        inj = P.FaultInjector(plan, _quiet_spec(P, jitter=jitter), seed=7)
        out.append([inj.duration(w, t, 100) for t in (0.0, 1.0, 2.5)
                    for w in range(4)])
    spec = P.ClusterSpec(num_workers=4, jitter=0.2, time_varying=True,
                         seed=0)
    inj = P.FaultInjector(P.FaultPlan.strained(4), spec, seed=3)
    out.append([inj.duration(w, t, 64) for t in (0.0, 1.0, 2.5, 77.0)
                for w in range(4)])
    return out


def case_injector_crash_once(P):
    plan = P.FaultPlan(4, crashes=(P.CrashEvent(2, at=5.0, recovery=3.0),
                                   P.CrashEvent(2, at=6.5, recovery=4.0)))
    inj = P.FaultInjector(plan, _quiet_spec(P), seed=0)
    seen = [_plain(inj.crash_between(w, t0, t1)) for w, t0, t1 in (
        (2, 0.0, 4.0), (1, 0.0, 10.0), (2, 4.0, 6.0), (2, 4.0, 6.0),
        (2, 6.0, 7.0), (2, 6.0, 7.0))]
    return (seen, inj.lost_tokens, _plain(inj.crash_log),
            _plain(inj.down_until),
            [inj.is_down(2, t) for t in (7.9, 8.0, 10.4, 10.5)])


def case_injector_scrapes_and_applies(P):
    plan = P.FaultPlan(2, dropouts=(P.ScrapeDropout(1.0, 2.0),),
                       apply_failures=(3, 4, 5))
    inj = P.FaultInjector(plan, _quiet_spec(P, 2), seed=0)
    rates = [1.0, 2.0]
    return ([inj.scrape(t, rates) for t in (0.5, 1.5, 1.9, 2.0)],
            inj.dropped_scrapes, [inj.apply_fails(g) for g in range(7)])


CASES = {name[5:]: fn for name, fn in globals().items()
         if name.startswith("case_")}


@pytest.mark.parametrize("case", sorted(CASES))
def test_faults_match_the_reference(case):
    want = CASES[case](PACKAGES["reference"])
    got = CASES[case](PACKAGES["port"])
    assert got == want


def test_each_package_draws_from_its_own_cluster():
    assert jax_faults.ClusterSpec is jax_cluster.ClusterSpec
    assert torch_faults.ClusterSpec is torch_cluster.ClusterSpec
