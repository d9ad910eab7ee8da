"""Rank workers of the tests of the port's ``parallel`` package.

``run_world`` spawns ``world`` processes that import torch and the port,
never JAX, join them in a gloo process group through a ``file://``
rendezvous (so that test workers running side by side never share a
port), run one job over every case of a test file and return each rank's
outputs. Every world has a deadline: a 120 s process-group timeout and a
joined one; a rank that fails, hangs or dies fails the test.
"""

from __future__ import annotations

import datetime
import multiprocessing as mp
import os
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

DEADLINE_S = 120.0


def run_world(world: int, job: str, inputs: dict, tmp_path: Path) -> list:
    """Run ``JOBS[job]`` on ``world`` gloo ranks; returns their outputs."""
    tag = f"{job}_{world}"
    in_path = tmp_path / f"in_{tag}.pt"
    torch.save(inputs, in_path)
    outs = [tmp_path / f"out_{tag}_{r}.pt" for r in range(world)]
    init = f"file://{tmp_path / f'rdv_{tag}'}"
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, world, init, job, str(in_path), str(outs[r])))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + DEADLINE_S
    for p in procs:
        p.join(max(0.1, deadline - time.monotonic()))
    hung = [r for r, p in enumerate(procs) if p.is_alive()]
    for p in procs:
        if p.is_alive():
            p.terminate()
            p.join(10)
    codes = [p.exitcode for p in procs]
    if hung or any(c != 0 for c in codes):
        errs = [(tmp_path / f"err_{tag}_{r}.txt") for r in range(world)]
        text = "".join(e.read_text() for e in errs if e.exists())
        raise AssertionError(f"{job} on {world} ranks: exit codes {codes}, past the "
                             f"deadline {hung}\n{text}")
    return [torch.load(o, weights_only=False) for o in outs]


def _rank_main(rank: int, world: int, init: str, job: str, in_path: str, out_path: str):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=DEADLINE_S))
    try:
        inputs = torch.load(in_path, weights_only=False)
        out = JOBS[job](inputs)
        torch.save(out, out_path + ".tmp")
        os.replace(out_path + ".tmp", out_path)
        dist.barrier()
    except BaseException:
        Path(out_path).with_name(Path(out_path).name.replace("out_", "err_", 1)).with_suffix(
            ".txt").write_text(f"rank {rank}:\n{traceback.format_exc()}")
        raise
    finally:
        dist.destroy_process_group()


def _np(t):
    if isinstance(t, (tuple, list)):
        return type(t)(_np(u) for u in t)
    return None if t is None else t.detach().cpu().numpy()


def _plans(pair):
    """A stacked plan carried across as (arrays, statics), or None."""
    import torch_nfft_tpu_torch as tp

    return None if pair is None else tp.plan_from_numpy(pair[0], **pair[1], device="cpu")


def _raises(fn, match: str) -> bool:
    try:
        fn()
    except ValueError as e:
        return match in str(e)
    return False


# ---------------------------------------------------------------------------
# Jobs: each takes the test file's inputs (one entry per case) and returns
# its outputs as numpy, keyed by case.
# ---------------------------------------------------------------------------


def point_sharded(inp: dict) -> dict:
    from torch_nfft_tpu_torch import parallel as par
    from torch_nfft_tpu_torch.ops.nfft import set_complex_override
    from torch_nfft_tpu_torch.parallel import _comm

    P, r = dist.get_world_size(), dist.get_rank()
    out = {}
    mesh = par.make_mesh(device_type="cpu")
    mesh2d = par.make_mesh({"data": 2, "points": -1}, device_type="cpu")
    out["mesh"] = (mesh.shape, mesh2d.shape, mesh2d.mesh_dim_names,
                   _raises(lambda: par.make_mesh({"data": 3, "points": -1}, device_type="cpu"),
                           "not divisible"),
                   _raises(lambda: par.make_mesh({"data": -1, "points": -1}, device_type="cpu"),
                           "at most one"))

    for dim in (1, 2):
        c = inp[f"adjoint{dim}"]
        out[f"adjoint{dim}"] = _np(par.nfft_adjoint_sharded(
            c["x"], c["pos"], c["batch"], bandwidth=c["N"], cutoff=c["m"], mesh=mesh,
            batch_size=c["B"]))
        c = inp[f"forward{dim}"]
        out[f"forward{dim}"] = _np(par.nfft_forward_sharded(
            c["x"], c["pos"], c["batch"], cutoff=c["m"], mesh=mesh, batch_size=c["B"]))

    c = inp["fastsum"]
    out["fastsum"] = _np(par.nfft_fastsum_sharded(
        c["x"], c["coeffs"], c["pos"], batch=c["batch"], cutoff=c["m"], mesh=mesh,
        batch_size=c["B"]))
    c = inp["fastsum_cols"]
    out["fastsum_cols"] = _np(par.nfft_fastsum_sharded(
        c["x"], c["coeffs"], c["pos"], batch=c["batch"], cutoff=c["m"], mesh=mesh2d,
        cols_axis="data", batch_size=1))

    c = inp["pad"]
    pos_p, x_p, batch_p, n_valid = par.pad_points(c["pos"], c["x"], c["batch"], multiple=P)
    out["pad"] = (pos_p.shape, n_valid, _np(par.nfft_adjoint_sharded(
        x_p, pos_p, batch_p, bandwidth=c["N"], cutoff=c["m"], mesh=mesh, batch_size=1)))

    for name in ("adjoint_plans", "forward_plans", "fastsum_plans"):
        c = inp[name]
        plans = _plans(c["plans"])
        own = par.build_sharded_plans(c["pos"], c["batch"], n_shards=P, N=c["N"], m=c["m"],
                                      batch_size=c["B"], device="cpu")
        if name == "adjoint_plans":
            y = par.nfft_adjoint_sharded(c["x"], c["pos"], c["batch"], bandwidth=c["N"],
                                         cutoff=c["m"], mesh=mesh, batch_size=c["B"],
                                         plans=plans)
            y_own = par.nfft_adjoint_sharded(c["x"], c["pos"], c["batch"], bandwidth=c["N"],
                                             cutoff=c["m"], mesh=mesh, batch_size=c["B"],
                                             plans=own)
        elif name == "forward_plans":
            y = par.nfft_forward_sharded(c["x"], c["pos"], c["batch"], cutoff=c["m"],
                                         mesh=mesh, batch_size=c["B"], plans=plans)
            y_own = par.nfft_forward_sharded(c["x"], c["pos"], c["batch"], cutoff=c["m"],
                                             mesh=mesh, batch_size=c["B"], plans=own)
        else:
            y = par.nfft_fastsum_sharded(c["x"], c["coeffs"], c["pos"], batch=c["batch"],
                                         cutoff=c["m"], mesh=mesh, batch_size=c["B"],
                                         source_plans=plans, target_plans=plans)
            y_own = par.nfft_fastsum_sharded(c["x"], c["coeffs"], c["pos"], batch=c["batch"],
                                             cutoff=c["m"], mesh=mesh, batch_size=c["B"],
                                             source_plans=own, target_plans=own)
        out[name] = (_np(y), _np(y_own))

    # gradients through the collectives: each rank's loss on the global output
    c = inp["grad_plans"]
    plans = _plans(c["plans"])
    x = torch.as_tensor(c["x"]).requires_grad_()
    y = par.nfft_fastsum_sharded(x, c["coeffs"], c["pos"], batch=c["batch"], cutoff=c["m"],
                                 mesh=mesh, batch_size=1, source_plans=plans,
                                 target_plans=plans)
    (y ** 2).sum().backward()
    out["grad_plans"] = _np(x.grad)

    c = inp["grad"]
    x = torch.as_tensor(c["x"]).requires_grad_()
    y = par.nfft_adjoint_sharded(x, c["pos"], c["batch"], bandwidth=c["N"], cutoff=c["m"],
                                 mesh=mesh, batch_size=c["B"])
    (torch.as_tensor(c["w_adj"]) * y.real + y.imag ** 2).sum().backward()
    g_adj = x.grad
    xs = torch.as_tensor(c["spec"]).requires_grad_()
    y = par.nfft_forward_sharded(xs, c["pos"], c["batch"], cutoff=c["m"], mesh=mesh,
                                 batch_size=c["B"])
    (y.abs() ** 2).sum().backward()
    g_fwd = xs.grad
    x2 = torch.as_tensor(c["x"]).requires_grad_()
    y = par.nfft_fastsum_sharded(x2, c["coeffs"], c["pos"], batch=c["batch"], cutoff=c["m"],
                                 mesh=mesh, batch_size=c["B"])
    (y ** 2).sum().backward()
    pos = torch.as_tensor(c["pos"]).requires_grad_()
    plans = _plans(c["plans"])
    y = par.nfft_adjoint_sharded(c["x"], pos, c["batch"], bandwidth=c["N"], cutoff=c["m"],
                                 mesh=mesh, batch_size=c["B"], plans=plans)
    (torch.as_tensor(c["w_adj"]) * y.real + y.imag ** 2).sum().backward()
    out["grad"] = (_np(g_adj), _np(g_fwd), _np(x2.grad), _np(pos.grad))

    # the train steps on (data: 2, points: P/2), each rank's block gathered
    c = inp["train"]
    step, shard = par.make_fastsum_train_step(
        mesh2d, c["coeffs"], batch_size=c["B"], n_per_set=c["n"], cutoff=c["m"],
        learning_rate=c["lr"])
    pos_l, y_l = shard(c["pos"]), shard(c["y"])
    w = shard(np.zeros_like(c["y"]))
    losses = []
    for i in range(6):
        w, loss = step(w, pos_l, y_l)
        losses.append(float(loss))
        if i == 0:
            w1 = w.clone()
    out["train"] = (losses, _gather_blocks(mesh2d, w1))
    c = inp["adam"]
    step, shard = par.make_fastsum_train_step(
        mesh2d, c["coeffs"], batch_size=c["B"], n_per_set=c["n"], cutoff=c["m"],
        optimizer=torch.optim.Adam, optimizer_kwargs={"lr": c["lr"]})
    pos_l, y_l = shard(c["pos"]), shard(c["y"])
    w = shard(np.zeros_like(c["y"]))
    state = step.init(w)
    losses = []
    for _ in range(9):
        w, loss, state = step(w, pos_l, y_l, state)
        losses.append(float(loss))
    out["adam"] = losses
    c = inp["planar"]
    res = []
    for override in (False, None):
        set_complex_override(override)
        step, shard = par.make_fastsum_train_step(
            mesh2d, c["coeffs"], batch_size=c["B"], n_per_set=c["n"], cutoff=c["m"],
            learning_rate=c["lr"])
        w1, loss = step(shard(c["w0"]), shard(c["pos"]), shard(c["y"]))
        res.append((_gather_blocks(mesh2d, w1), float(loss)))
    set_complex_override(None)
    out["planar"] = res

    c = inp["spectral"]
    g = torch.as_tensor(c["g"])  # channel-first (B, C, M0, M1, M2)
    L1 = g.shape[3] // P
    yr, yi = par.spectral_adjoint_pruned_dft_sharded(
        g[:, :, :, r * L1:(r + 1) * L1], None, 3, c["N"], c["m"], c["sigma"],
        mesh.get_group("points"), c["M"])
    gr, gi = par.spectral_forward_pruned_dft_sharded(
        torch.as_tensor(c["xr"]), torch.as_tensor(c["xi"]), 3, c["M"], c["m"], c["sigma"],
        mesh.get_group("points"), P)
    grp = mesh.get_group("points")
    out["spectral"] = (_np(yr), _np(yi), _np(_comm.all_gather_rows(gr, grp, 3)),
                       _np(_comm.all_gather_rows(gi, grp, 3)))

    c = inp["errors"]
    plans = par.build_sharded_plans(c["pos"], c["batch"], n_shards=P, N=c["N"], m=c["m"],
                                    batch_size=1, device="cpu")
    kw = dict(mesh=mesh, batch_size=1)
    out["errors"] = [
        _raises(lambda: par.nfft_adjoint_sharded(c["x"], c["pos"], c["batch"],
                                                 bandwidth=c["N"], cutoff=c["m"], plans=plans,
                                                 window="es", **kw), "window"),
        _raises(lambda: par.nfft_forward_sharded(c["spec"], c["pos"], c["batch"],
                                                 cutoff=c["m"], plans=plans, window="es",
                                                 **kw), "window"),
        _raises(lambda: par.nfft_fastsum_sharded(c["x"], c["coeffs"], c["pos"],
                                                 batch=c["batch"], cutoff=c["m"],
                                                 source_plans=plans, target_plans=plans,
                                                 window="es", **kw), "window"),
        _raises(lambda: par.nfft_adjoint_sharded(c["x"], c["pos"], c["batch"],
                                                 bandwidth=c["N"], cutoff=c["m"], plans=plans,
                                                 sigma=1.5, **kw), "sigma"),
    ]

    # independent sets, one a rank: zero collectives
    c = inp["sets"]
    import torch_nfft_tpu_torch as tp

    zb = torch.zeros(c["n"], dtype=torch.int32)
    pr = torch.as_tensor(c["pos"][r])
    yr, yi = tp.nfft_adjoint_planar(c["x"][r], pr, zb, batch_size=1, N=c["N"], m=c["m"],
                                    device="cpu")
    zr, _ = tp.nfft_forward_planar(yr, yi, pr, zb, batch_size=1, dim=2, m=c["m"],
                                   real_output=True, device="cpu")
    out["sets"] = _np(_comm.all_gather_rows(zr[None], dist.group.WORLD, 0))
    return out


def _gather_blocks(mesh, w: torch.Tensor) -> np.ndarray:
    """The global (batch_size, n_per_set, C) from each rank's block."""
    from torch_nfft_tpu_torch.parallel import _comm

    w = _comm.all_gather_rows(w, mesh.get_group("points"), 1)
    return _np(_comm.all_gather_rows(w, mesh.get_group("data"), 0))


def _layout(c: dict, P: int):
    """The port's own layout of a case, and JAX's carried across."""
    import torch_nfft_tpu_torch as tp
    from torch_nfft_tpu_torch import parallel as par

    own = par.build_grid_sharded_layout(c["pos"], n_shards=P, N=c["N"], m=c["m"], T=c["T"],
                                        window=c.get("window", "gaussian"), device="cpu")
    j = c["jlay"]
    return own, tp.grid_layout_from_numpy(j["plans"], j["pos_stack"], j["point_index"],
                                          **j["statics"], device="cpu")


def grid_sharded(inp: dict) -> dict:
    from torch_nfft_tpu_torch import parallel as par
    from torch_nfft_tpu_torch.parallel import _comm

    P, r = dist.get_world_size(), dist.get_rank()
    mesh = par.make_mesh({"grid": P}, device_type="cpu")
    out = {}
    for key, c in inp.items():
        if key.startswith("adjoint") or key == "empty":
            own, jl = _layout(c, P)
            out[key] = [_np(par.nfft_adjoint_grid_sharded(c["x"], lay, mesh)) for lay in (own, jl)]
            if key == "adjoint0":
                out["layout"] = (_np(own.pos_stack), _np(own.point_index),
                                 {k: _np(getattr(own.plans, k)) for k in
                                  ("slot_pt", "slot_pos", "origin", "row_batch", "fill_keys",
                                   "row_count")}, own.A0_loc, own.T)
        elif key.startswith("forward"):
            own, jl = _layout(c, P)
            out[key] = [_np(par.nfft_forward_grid_sharded(
                torch.as_tensor(c["xr"]), torch.as_tensor(c["xi"]), lay, mesh,
                real_output=c["real"])) for lay in (own, jl)]
        elif key.startswith("fastsum"):
            own, jl = _layout(c, P)
            out[key] = [_np(par.nfft_fastsum_grid_sharded(c["x"], c["coeffs"], lay, mesh))
                        for lay in (own, jl)]
        elif key == "roundtrip":
            own, _ = _layout(c, P)
            yr, yi = par.nfft_adjoint_grid_sharded(c["x"], own, mesh)
            out[key] = _np(par.nfft_forward_grid_sharded(yr, yi, own, mesh, real_output=True)[0])
        elif key == "grad":
            own, _ = _layout(c, P)
            x = torch.as_tensor(c["x"]).requires_grad_()
            yr, yi = par.nfft_adjoint_grid_sharded(x, own, mesh)
            (yr ** 2 + yi ** 2).sum().backward()
            xr = torch.as_tensor(c["sr"]).requires_grad_()
            xi = torch.as_tensor(c["si"]).requires_grad_()
            zr, zi = par.nfft_forward_grid_sharded(xr, xi, own, mesh)
            (zr ** 2 + zi ** 2).sum().backward()
            x2 = torch.as_tensor(c["x"]).requires_grad_()
            (par.nfft_fastsum_grid_sharded(x2, c["coeffs"], own, mesh) ** 2).sum().backward()
            out[key] = (_np(x.grad), _np(xr.grad), _np(xi.grad), _np(x2.grad))
        elif key == "spectral":
            g = torch.as_tensor(c["g"])  # (B, C, M0, M1, M2)
            grp = mesh.get_group("grid")
            L0 = g.shape[2] // P
            yr, yi = par.spectral_adjoint_pruned_dft_sharded0(
                g[:, :, r * L0:(r + 1) * L0], None, 3, c["N"], c["m"], c["sigma"], grp, c["M"])
            gr, gi = par.spectral_forward_pruned_dft_sharded0(
                torch.as_tensor(c["xr"]), torch.as_tensor(c["xi"]), 3, c["M"], c["m"],
                c["sigma"], grp, P)
            out[key] = (_np(yr), _np(yi), _np(_comm.all_gather_rows(gr, grp, 2)),
                        _np(_comm.all_gather_rows(gi, grp, 2)))
    return out


def grid_pair(inp: dict) -> dict:
    """The grid-sharded pair: the adjoint, then the real forward, of each
    case's values on the rank's slab of the world."""
    from torch_nfft_tpu_torch import parallel as par

    P = dist.get_world_size()
    mesh = par.make_mesh({"grid": P}, device_type="cpu")
    out = {}
    for key, c in inp.items():
        lay = par.build_grid_sharded_layout(c["pos"], n_shards=P, N=c["N"], m=c["m"],
                                            device="cpu")
        yr, yi = par.nfft_adjoint_grid_sharded(torch.as_tensor(c["x"]), lay, mesh)
        out[key] = _np(par.nfft_forward_grid_sharded(yr, yi, lay, mesh, real_output=True)[0])
    return out


JOBS = {"point_sharded": point_sharded, "grid_sharded": grid_sharded, "grid_pair": grid_pair}
