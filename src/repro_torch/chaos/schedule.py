"""Seeded random chaos-schedule generation.

Composes the fault DSL's verbs (`workload/scenario.py`) into a bounded
sequence of *episodes*: each episode injects one fault class, holds it,
then clears it (restart for crashes, `heal` for network/gray faults)
before the next begins, and the whole schedule ends fully healed with a
quiet tail.  Episodes are sequential on purpose — the availability
auditor then sees crisp majority-healthy windows between faults, so the
liveness check has teeth on every schedule instead of only on lucky
overlaps.

Generation uses its own `random.Random(seed)` — never the simulator's
stream — so the same seed yields the same schedule text regardless of
what the simulation itself consumes.
"""

from __future__ import annotations

import random

# every fault class the harness can inject; seeds rotate through these so
# any handful of seeds covers crashes, asymmetric cuts, symmetric
# partitions, lossy/duplicating/slow links, gray disk/CPU, and ZK flaps
EPISODES = ("crash", "crash_leader", "partition", "oneway", "drop_link",
            "dup_link", "slow_link", "slow_disk", "slow_cpu", "flap")


def generate_chaos_schedule(seed: int, n_nodes: int = 5,
                            duration: float = 18.0,
                            episodes: int = 5,
                            quiet_tail: float = 4.0,
                            n_ranges: int = 5) -> str:
    """Deterministic DSL text for one chaos run of `duration` seconds.

    The first `episodes` fault classes come from a seed-rotated walk over
    EPISODES (guaranteeing class diversity across consecutive seeds), the
    hold times and targets from `random.Random(seed)`."""
    rng = random.Random(seed)
    nodes = list(range(n_nodes))
    budget = duration - quiet_tail
    slot = budget / max(1, episodes)
    lines = [f"# chaos schedule seed={seed} nodes={n_nodes}"]
    classes = [EPISODES[(seed + i) % len(EPISODES)] for i in range(episodes)]
    rng.shuffle(classes)
    t = 0.4
    for kind in classes:
        hold = min(slot * 0.6, 0.8 + rng.random() * (slot * 0.5))
        t_inj = round(t, 2)
        t_clear = round(min(t + hold, budget - 0.1), 2)
        if t_clear <= t_inj:
            break
        if kind == "crash":
            n = rng.choice(nodes)
            lose = " lose_disk" if rng.random() < 0.25 else ""
            lines.append(f"at {t_inj}s crash node {n}{lose}")
            lines.append(f"at {t_clear}s restart node {n}")
        elif kind == "crash_leader":
            rid = rng.randrange(n_ranges)
            lines.append(f"at {t_inj}s crash leader of {rid}")
            lines.append(f"at {t_clear}s restart crashed")
        elif kind == "partition":
            k = rng.randrange(1, (n_nodes - 1) // 2 + 1)
            minority = rng.sample(nodes, k)
            majority = [n for n in nodes if n not in minority]
            lines.append(
                "at %ss partition {%s} | {%s}"
                % (t_inj, ",".join(map(str, sorted(minority))),
                   ",".join(map(str, sorted(majority)))))
            lines.append(f"at {t_clear}s heal")
        elif kind == "oneway":
            k = rng.randrange(1, (n_nodes - 1) // 2 + 1)
            src = rng.sample(nodes, k)
            dst = [n for n in nodes if n not in src]
            lines.append(
                "at %ss partition oneway {%s} -> {%s}"
                % (t_inj, ",".join(map(str, sorted(src))),
                   ",".join(map(str, sorted(dst)))))
            lines.append(f"at {t_clear}s heal")
        elif kind in ("drop_link", "dup_link", "slow_link"):
            a, b = rng.sample(nodes, 2)
            if kind == "drop_link":
                p = round(0.1 + rng.random() * 0.4, 2)
                lines.append(f"at {t_inj}s drop link {a} {b} p={p}")
            elif kind == "dup_link":
                p = round(0.1 + rng.random() * 0.4, 2)
                lines.append(f"at {t_inj}s dup link {a} {b} p={p}")
            else:
                f = round(4 + rng.random() * 12, 1)
                lines.append(f"at {t_inj}s slow link {a} {b} x{f}")
            lines.append(f"at {t_clear}s heal")
        elif kind in ("slow_disk", "slow_cpu"):
            n = rng.choice(nodes)
            f = round(5 + rng.random() * 20, 1)
            what = "disk" if kind == "slow_disk" else "cpu"
            lines.append(f"at {t_inj}s slow {what} on {n} x{f}")
            lines.append(f"at {t_clear}s heal")
        else:   # flap
            n = rng.choice(nodes)
            outage = round(0.5 + rng.random() * 1.0, 2)
            lines.append(f"at {t_inj}s flap session of {n} for {outage}s")
        t = t_clear + 0.3
    lines.append(f"at {round(budget, 2)}s heal")
    return "\n".join(lines) + "\n"
