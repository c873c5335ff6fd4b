"""Command-line interface.

The reference builds three executables -- ``gple.x`` (the GPR-MQCLE main
program), ``dvr`` (exact Schroedinger), and ``mqcl`` (exact grid Liouville) --
all driven by the same 8-field ``input`` text file.  Here they are subcommands
of one CLI:

    python -m gple_tpu.cli gple --input input --outdir out [--model DAC]
    python -m gple_tpu.cli se   --input input --outdir out [--boundary absorbing]
    python -m gple_tpu.cli le   --input input --outdir out

Each writes the reference's output file schema into ``--outdir``.
"""

from __future__ import annotations

import argparse
import sys


def _common(ap):
    ap.add_argument("--input", default="input", help="reference-format input file")
    ap.add_argument("--outdir", default="output", help="output directory")
    ap.add_argument("--model", default="DAC", choices=["SAC", "DAC", "ECR"],
                    help="Tully model (the reference's compile-time TestModel)")
    ap.add_argument("--max-outputs", type=int, default=None)
    ap.add_argument("--platform", default=None, help="jax platform override (e.g. cpu)")


def main(argv=None):
    ap = argparse.ArgumentParser(prog="gple_tpu")
    sub = ap.add_subparsers(dest="cmd", required=True)

    g = sub.add_parser("gple", help="GPR-MQCLE propagation (reference gple.x)")
    _common(g)
    g.add_argument("--max-ticks", type=int, default=None)
    g.add_argument("--checkpoint", default=None)
    g.add_argument("--checkpoint-every", type=int, default=0)
    g.add_argument("--resume", default=None)
    g.add_argument("--quiet", action="store_true")
    g.add_argument("--opt-mode", default=None, choices=["moment", "ladder"],
                   help="hyperparameter strategy (default: moment; see "
                   "GPLEConfig.opt_mode)")
    g.add_argument("--reference-parity", action="store_true",
                   help="run-for-run comparable to the reference: evolution "
                   "cutoff on, initial purity target, corr pinned to 1, "
                   "constrained-ladder optimizer")

    s = sub.add_parser("se", help="exact DVR Schroedinger solver (reference dvr)")
    _common(s)
    s.add_argument("--boundary", default="absorbing",
                   choices=["reflective", "periodic", "absorbing"])
    s.add_argument("--no-wigner", action="store_true")

    l = sub.add_parser("le", help="exact grid-MQCLE solver (reference mqcl)")
    _common(l)

    opts = ap.parse_args(argv)

    import jax

    if opts.platform:
        jax.config.update("jax_platforms", opts.platform)
    jax.config.update("jax_enable_x64", True)
    from gple_tpu.utils.cache import enable_persistent_cache

    enable_persistent_cache()

    from gple_tpu.config import GPLEConfig

    extra = {}
    if getattr(opts, "opt_mode", None):
        extra["opt_mode"] = opts.opt_mode
    if getattr(opts, "reference_parity", False):
        extra["reference_parity"] = True
    cfg = GPLEConfig.from_input_file(opts.input, model=opts.model, **extra)

    if opts.cmd == "gple":
        from gple_tpu.driver import GPLEDriver

        drv = GPLEDriver(cfg, outdir=opts.outdir, verbose=not opts.quiet)
        hist = drv.run(
            max_ticks=opts.max_ticks,
            checkpoint_path=opts.checkpoint,
            checkpoint_every=opts.checkpoint_every,
            resume_from=opts.resume,
        )
        last = hist[-1]
        # final stdout line mirrors the reference (p0 / lnE + final populations)
        import math

        lead = math.log(cfg.p0**2 / 2.0 / cfg.mass) if cfg.model == "DAC" else cfg.p0
        print(lead, *last.population_mci)
        return 0

    if opts.cmd == "se":
        from gple_tpu.oracles.schrodinger import DVRConfig, DVRSolver

        # interaction region +-2|x0| (the GPLE grid convention, input.cpp:37)
        se_cfg = DVRConfig(
            model=opts.model, boundary=opts.boundary, mass=cfg.mass, x0=cfg.x0,
            p0=cfg.p0, sigma_p=cfg.sigma_p0, xmin=cfg.xmin, xmax=cfg.xmax,
            dx_input=1.0, output_time=cfg.output_time, dt_input=cfg.dt,
        )
        res = DVRSolver(se_cfg).run(
            store_wigner=not opts.no_wigner, max_outputs=opts.max_outputs
        )
        res.save_txt(opts.outdir)
        import math

        lead = (
            math.log(cfg.p0**2 / 2.0 / cfg.mass) if opts.model == "DAC" else cfg.p0
        )
        print(lead, *res.populations[-1])
        return 0

    if opts.cmd == "le":
        from gple_tpu.oracles.liouville import LiouvilleConfig, LiouvilleSolver

        le_cfg = LiouvilleConfig(
            model=opts.model, mass=cfg.mass, x0=cfg.x0, p0=cfg.p0,
            sigma_p=cfg.sigma_p0, xmin=cfg.xmin, xmax=cfg.xmax,
            dx_input=1.0, output_time=cfg.output_time, dt_input=cfg.dt,
        )
        res = LiouvilleSolver(le_cfg).run(max_outputs=opts.max_outputs)
        res.save_txt(opts.outdir)
        import math

        lead = (
            math.log(cfg.p0**2 / 2.0 / cfg.mass) if opts.model == "DAC" else cfg.p0
        )
        print(lead, *res.populations[-1])
        return 0

    return 1


if __name__ == "__main__":
    sys.exit(main())
