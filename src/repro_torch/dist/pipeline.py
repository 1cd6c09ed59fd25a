"""Pipeline parallelism: a GPipe schedule over a mesh dim, plus napkin math
for choosing pipeline- vs data-parallelism across a slow interconnect; a
port of `repro/dist/pipeline.py`.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh


def bubble_fraction(n_micro: int, n_stages: int) -> float:
    """Fraction of device time idle in a GPipe schedule.

    A pipeline of S stages fed M microbatches runs M + S - 1 ticks, of
    which S - 1 per device are fill/drain bubble.
    """
    return (n_stages - 1) / (n_micro + n_stages - 1)


def pp_vs_dp_napkin(grad_bytes: float, dcn_bw: float, step_compute_s: float,
                    n_micro: int, n_stages: int) -> dict:
    """Back-of-envelope: pipeline across a slow link vs data-parallel
    all-reduce over it.

    DP pays a ~2x grad-bytes all-reduce on the link every step; PP pays the
    fill/drain bubble instead (cross-stage activations are ignored — they
    are tiny next to full gradients at napkin precision).
    """
    dp_allreduce_s = 2.0 * grad_bytes / dcn_bw
    bubble_s = step_compute_s * bubble_fraction(n_micro, n_stages)
    return {
        "dp_allreduce_s": dp_allreduce_s,
        "bubble_s": bubble_s,
        "pp_wins": bool(bubble_s < dp_allreduce_s),
        "advantage_s": dp_allreduce_s - bubble_s,
    }


def gpipe(stage_fn: Callable, mesh: DeviceMesh,
          axis: str = "pipe") -> Callable:
    """Build a GPipe runner over the mesh dim `axis`.

    `stage_fn(W_stage, x)` applies one pipeline stage.  The returned
    `run(Ws, x)` takes stage-stacked params `Ws: (n_stages, ...)` and
    microbatched inputs `x: (n_micro, mb, ...)`, the same on every rank,
    and equals applying the stages sequentially to every microbatch.
    Stage s runs on the rank at position s along `axis`; each of the
    M + S - 1 ticks applies this rank's stage and passes its activation
    round the ring with `batch_isend_irecv` over the axis's process group
    (a ring of one keeps it, as JAX's ppermute to itself does).  The last
    stage's buffer is broadcast, so every rank returns (n_micro, mb, ...).
    """
    names = tuple(mesh.mesh_dim_names)
    n_devices = mesh.shape[names.index(axis)]
    group = mesh.get_group(axis)
    stage = mesh.get_local_rank(axis)

    def run(Ws: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        n_stages = Ws.shape[0]
        if n_stages != n_devices:
            raise ValueError(
                f"gpipe: {n_stages} stages but mesh axis {axis!r} has "
                f"{n_devices} devices (need exactly one stage per device)")
        n_micro = x.shape[0]
        ticks = n_micro + n_stages - 1
        nxt = dist.get_global_rank(group, (stage + 1) % n_devices)
        prv = dist.get_global_rank(group, (stage - 1) % n_devices)
        W = Ws[stage]                       # this rank's stage params
        state = torch.zeros_like(x[0])
        out = torch.zeros_like(x)
        for t in range(ticks):
            # stage 0 injects microbatch t; the others consume the
            # activation passed at the previous tick
            x_in = x[min(t, n_micro - 1)] if stage == 0 else state
            y = stage_fn(W, x_in)
            # the last stage finishes microbatch t - (S - 1) at tick t
            mb_done = t - (n_stages - 1)
            if stage == n_stages - 1 and mb_done >= 0:
                out[mb_done] = y
            if n_devices == 1:
                state = y
                continue
            state = torch.empty_like(y)
            for req in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, y.contiguous(), nxt, group),
                    dist.P2POp(dist.irecv, state, prv, group)]):
                req.wait()
        dist.broadcast(out, dist.get_global_rank(group, n_stages - 1),
                       group=group)
        return out

    return run
