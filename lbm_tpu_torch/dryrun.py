"""The multi-device dry run: every sharded path of the port, once, on n ranks.

The counterpart of `__graft_entry__.dryrun_multichip` (its `_dryrun_impl`),
at the reference's tiny shapes, in the same order:

  1. the 2-D halo exchange (`halo.simulate_sharded`, 'ppermute') on the best
     (rows, cols) mesh;
  2. the 2-D ghost-band path (`kstep_sharded.simulate`, K = 4) on a 2-D mesh
     (2, n/2) when n is even and at least 4, else a row mesh;
  3. its row overlap on a row mesh;
  4. its 'full2d' overlap on the (2, n/2) mesh (even n >= 4 only, as in the
     reference);
  5. the 3-D ghost-plane path (`kstep_sharded_3d.simulate`, K = 2) on a
     z-mesh of n;
  6. the same with the exchange/compute overlap;
  7. the 3-D (z, y) mesh with an uneven nz (pad-and-mask);
  8. the 2-D halo exchange on a grid that divides neither mesh axis
     (pad-and-mask), then the conv-sharded blur.

The ranks are started by `parallel.launch`: NCCL, one rank a GPU, by default;
gloo ranks on the CPU with device='cpu'. Asking for more CUDA ranks than GPUs,
or for CUDA where there is none, raises. Each stage checks its result (finite
state, av_vels of the right length) and prints one line; the call raises if a
stage fails, naming it. Run it with

    python -m lbm_tpu_torch.dryrun 4 --device cpu   # 4 gloo ranks
    python -m lbm_tpu_torch.dryrun 4                # 4 GPUs
"""

from __future__ import annotations

import sys

import numpy as np


def dryrun_multichip(n_devices: int, device: str = "cuda") -> list[str]:
    """Every stage on n_devices ranks; prints and returns one line a stage."""
    from . import dryrun  # the body by its import path, also under `python -m`
    from .parallel import launch

    lines = launch.run(dryrun._stages, n_devices, n_devices, device_type=device, timeout=600)
    for line in lines:
        print(line)
    return lines


def _check(name: str, f, av, steps: int) -> None:
    f, av = np.asarray(f), np.asarray(av)
    if av.shape != (steps,) or not np.isfinite(f).all() or not np.isfinite(av).all():
        raise RuntimeError(f"{name}: av_vels of shape {av.shape}, finite state "
                           f"{bool(np.isfinite(f).all())}")


def _stages(n: int) -> list[str]:
    """The body of dryrun_multichip on each rank; rank 0's lines are kept."""
    from .core import state
    from .core.params import Params
    from .models import blur as blur_model
    from .parallel import halo, kstep_sharded, kstep_sharded_3d, mesh as mesh_lib

    lines = []

    def stage(name, fn):
        try:
            lines.append(f"dryrun_multichip({n}): {fn()}")
        except Exception as err:
            raise RuntimeError(f"dryrun_multichip({n}) stage '{name}' failed: {err}") from err

    def plane_case(ny, nx, steps):
        p = Params(nx=nx, ny=ny, max_iters=steps, reynolds_dim=10, density=0.1, accel=0.005,
                   omega=1.85)
        mask = np.zeros((ny, nx), bool)
        mask[0, :] = True
        return p, state.initial_distributions(p, np.float32), mask

    r, c = mesh_lib.best_factorisation(n, n * 8, n * 8)
    two_axes = n >= 4 and n % 2 == 0

    def ppermute():
        p, f, mask = plane_case(8 * r, 16 * c, 2)
        f_final, av = halo.simulate_sharded(p, f, mask, mesh_lib.make_mesh2d(r, c),
                                            strategy="ppermute")
        _check("ppermute", f_final.cpu(), av.cpu(), 2)
        return f"mesh {r}x{c}, grid {p.ny}x{p.nx}, av_vels={av.cpu().numpy()}"

    def ghost_band():
        rows, cols = (2, n // 2) if two_axes else (n, 1)
        p, f, mask = plane_case(16 * rows, 128 * cols, 4)
        f_final, av = kstep_sharded.simulate(p, f, mask, mesh_lib.make_mesh2d(rows, cols),
                                             k_steps=4)
        _check("sharded-cuda", f_final.cpu(), av.cpu(), 4)
        return (f"sharded-cuda mesh {rows}x{cols} grid {p.ny}x{p.nx} k=4 "
                f"av_vels={av.cpu().numpy()}")

    def row_overlap():
        p, f, mask = plane_case(24 * n, 128, 4)
        f_final, av = kstep_sharded.simulate(p, f, mask, mesh_lib.make_mesh2d(n, 1), k_steps=4,
                                             overlap=True)
        _check("row overlap", f_final.cpu(), av.cpu(), 4)
        return (f"sharded-cuda OVERLAP row-mesh {n} grid {p.ny}x{p.nx} k=4 "
                f"av_vels={av.cpu().numpy()}")

    def full2d():
        rows, cols = 2, n // 2
        p, f, mask = plane_case(24 * rows, 384 * cols, 4)
        f_final, av = kstep_sharded.simulate(p, f, mask, mesh_lib.make_mesh2d(rows, cols),
                                             k_steps=4, overlap=True, scheme="full2d")
        _check("full2d", f_final.cpu(), av.cpu(), 4)
        return (f"sharded-cuda FULL2D overlap mesh {rows}x{cols} grid {p.ny}x{p.nx} k=4 "
                f"av_vels={av.cpu().numpy()}")

    def z_mesh(overlap):
        nz = (6 if overlap else 4) * n
        f_final, av = kstep_sharded_3d.simulate(nz, 8, 128, num_steps=4,
                                                mesh=kstep_sharded_3d.make_z_mesh(n), k_steps=2,
                                                overlap=overlap)
        _check("3-D z-mesh", f_final.cpu(), av.cpu(), 4)
        return (f"kstep_sharded_3d {'overlap ' if overlap else ''}z-mesh {n} grid {nz}x8x128 "
                f"k=2 av_vels={av.cpu().numpy()}")

    def zy_mesh():
        n_z, n_y = (2, n // 2) if two_axes else (n, 1)
        nz, ny = 4 * n_z + 2, 8 * n_y  # +2: uneven z, pad-and-mask
        f_final, av = kstep_sharded_3d.simulate_zy(
            nz, ny, 128, num_steps=4, mesh=kstep_sharded_3d.make_zy_mesh(n_z, n_y), k_steps=2)
        _check("3-D (z, y) mesh", f_final.cpu(), av.cpu(), 4)
        return (f"kstep_sharded_3d ZY-mesh {n_z}x{n_y} grid {nz}x{ny}x128 k=2 (uneven z) "
                f"av_vels={av.cpu().numpy()}")

    def uneven():
        p, f, mask = plane_case(2 * n * 8 + 2, 130, 2)
        f_final, av = halo.simulate_sharded(p, f, mask, mesh_lib.make_mesh2d(r, c),
                                            strategy="ppermute")
        _check("uneven", f_final.cpu(), av.cpu(), 2)
        return (f"halo ppermute UNEVEN grid {p.ny}x{p.nx} on mesh {r}x{c} (pad-and-mask) "
                f"av_vels={av.cpu().numpy()}")

    def conv_sharded():
        rgba = np.random.default_rng(5).integers(0, 255, size=(62, 126, 4), dtype=np.uint8)
        device = mesh_lib.local_device()
        run = blur_model.run_blur(rgba, num_iters=2, engine="conv-sharded", num_devices=n,
                                  device=device)
        if run.rgba.shape != rgba.shape or run.rgba.dtype != np.uint8:
            raise RuntimeError(f"blurred image of shape {run.rgba.shape}, {run.rgba.dtype}")
        return (f"conv-sharded blur {rgba.shape[0]}x{rgba.shape[1]} ok "
                f"(mean {float(run.rgba[..., :3].mean()):.1f})")

    stage("2-D ppermute", ppermute)
    stage("2-D sharded-cuda", ghost_band)
    stage("2-D row overlap", row_overlap)
    if two_axes:
        stage("2-D full2d overlap", full2d)
    stage("3-D z-mesh", lambda: z_mesh(False))
    stage("3-D overlap", lambda: z_mesh(True))
    stage("3-D (z, y) mesh", zy_mesh)
    stage("2-D uneven pad-and-mask", uneven)
    stage("conv-sharded blur", conv_sharded)
    return lines


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="the port's multi-device dry run")
    parser.add_argument("num_devices", type=int, nargs="?", default=4)
    parser.add_argument("--device", default="cuda", choices=["cpu", "cuda"])
    args = parser.parse_args(argv)
    dryrun_multichip(args.num_devices, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
