"""Command-line driver — the analog of the reference executables
`bem_stokes_2d/3d [start_frame [end_frame [compose]]]` (`source/main.cc:5-74`).

Usage:
    bemstokes run   [-p params.{json,prm}] [--dim 2|3] [start [end]] [-o DIR]
    bemstokes compose [-p params] start end [-o DIR]    # offline re-aggregation
    bemstokes params [-p out.json] [--dim 2|3]          # write a template
                                                        # (reference main.cc:34-37
                                                        # auto-generates a prm)

Like the reference, `run` executes the frame loop start..end and writes
per-frame VTU + checkpoint state to the output directory; `compose` re-reads
those dumps and aggregates composed motion (reference `composer`,
`source/bem_stokes.cc:5951-6046`).
"""

from __future__ import annotations

import argparse
import os
import sys


def _build_parser():
    p = argparse.ArgumentParser(prog="bemstokes", description=__doc__)
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("-p", "--params", default=None, help="params .json or .prm")
        sp.add_argument("--dim", type=int, default=3, choices=(2, 3))
        sp.add_argument("-o", "--output-dir", default=".")
        sp.add_argument(
            "--platform",
            default=None,
            choices=("cpu", "gpu"),
            help="force the JAX platform (e.g. --platform cpu for a "
            "host-only validation run)",
        )

    run = sub.add_parser("run", help="run the frame-loop simulation")
    common(run)
    run.add_argument("start_frame", nargs="?", type=int, default=0)
    run.add_argument("end_frame", nargs="?", type=int, default=None)
    run.add_argument(
        "--profile",
        default=None,
        metavar="DIR",
        help="capture a jax.profiler device trace of the frame loop into "
        "DIR (open with TensorBoard / xprof; complements the built-in "
        "per-phase wall-clock timers)",
    )

    comp = sub.add_parser("compose", help="offline composition of saved frames")
    common(comp)
    comp.add_argument("start_frame", type=int)
    comp.add_argument("end_frame", type=int)

    par = sub.add_parser("params", help="write a template parameter file")
    par.add_argument("-p", "--params", default="parameters_3d.json")
    par.add_argument("--dim", type=int, default=3, choices=(2, 3))

    conv = sub.add_parser(
        "convergence",
        help="fundamental-solution convergence study over n_cycles "
        "refinements (reference V_test_with_Green family)",
    )
    common(conv)
    conv.add_argument("--cycles", type=int, default=None, help="override n_cycles")
    conv.add_argument(
        "--source",
        type=float,
        nargs="+",
        default=None,
        help="interior Stokeslet source point (default 0.3 0.3 0.3 / 0.1 0.2)",
    )
    return p


def main(argv=None):
    args = _build_parser().parse_args(argv)

    import jax

    if getattr(args, "platform", None):
        # after the jax import but before any computation
        jax.config.update("jax_platforms", args.platform)

    from .utils.compile_cache import enable_compile_cache

    enable_compile_cache()

    # multi-host: engage jax.distributed when launched under a multi-process
    # runner (JAX_COORDINATOR_ADDRESS / JAX_NUM_PROCESSES / JAX_PROCESS_ID
    # env vars); single-process no-op otherwise
    # (reference: every rank enters main() identically, `source/main.cc:22`)
    from .parallel.multihost import initialize_multihost

    multihost = initialize_multihost()
    if multihost:
        import jax

        print(
            f"multi-host: process {jax.process_index()}/{jax.process_count()}"
            f", {len(jax.devices())} global devices",
            file=sys.stderr,
        )

    from .config import ProblemConfig
    from .config_io import load_config, save_config

    if args.command == "params":
        cfg = ProblemConfig(dim=args.dim)
        save_config(cfg, args.params)
        print(f"wrote template parameters to {args.params}")
        return 0

    if args.params:
        cfg = load_config(args.params, dim=args.dim)
        cfg.dim = args.dim
    else:
        # reference behavior: missing parameter file -> write the template
        # and proceed with defaults (source/main.cc:34-37)
        cfg = ProblemConfig(dim=args.dim)
        path = os.path.join(args.output_dir, f"parameters_{args.dim}d.json")
        os.makedirs(args.output_dir, exist_ok=True)
        save_config(cfg, path)
        print(f"no parameter file given; wrote defaults to {path}", file=sys.stderr)

    if args.command == "convergence":
        from .convergence import convergence_study, format_table
        from .mesh import read_mesh
        from .problem import _resolve_manifold

        mesh = read_mesh(
            f"{cfg.input_grid_path}{cfg.input_grid_base_name}0."
            f"{cfg.input_grid_format}",
            dim=cfg.dim,
            force_material=0,
        )
        source = tuple(args.source) if args.source else (
            (0.3, 0.3, 0.3) if cfg.dim == 3 else (0.1, 0.2)
        )
        rows = convergence_study(
            mesh,
            cfg.dim,
            source,
            n_cycles=args.cycles or cfg.n_cycles,
            manifold=_resolve_manifold(cfg),
            fe_degree=cfg.fe_degree,
            map_degree=cfg.map_degree,
            quad_order=cfg.quadrature.order,
            sing_order=cfg.quadrature.singular_order,
        )
        print(format_table(rows))
        return 0

    from .swimmer import SwimmerSimulation

    sim = SwimmerSimulation(cfg, output_dir=args.output_dir)
    if args.command == "run":
        end = args.end_frame if args.end_frame is not None else cfg.n_frames
        if getattr(args, "profile", None):
            # device trace of the frame loop (the analog of the reference's
            # Teuchos timers for kernel-level analysis; the wall-clock phase
            # table still prints at end of run)
            import contextlib

            with contextlib.ExitStack() as stack:
                try:
                    stack.enter_context(jax.profiler.trace(args.profile))
                except Exception as e:  # pragma: no cover
                    print(f"profiler unavailable: {e}", file=sys.stderr)
                sim.run(args.start_frame, end)
        else:
            sim.run(args.start_frame, end)
    else:
        sim.compose(args.start_frame, args.end_frame)
    # echo the fully-expanded parameters (used_parameters_*.prm analog)
    save_config(cfg, os.path.join(args.output_dir, f"used_parameters_{args.dim}d.json"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
