"""Guarded training loop: any lm / gnn / recsys arch × synthetic data ×
fault tolerance (the port of ``repro.launch.train``).

:func:`run_training` executes a :class:`~repro_torch.api.spec.TrainSpec`
on one device: build the arch's config (reduced by default; ``full``
for the published one), its train step and data, restore the latest
checkpoint if there is one, then run the steps with

  * periodic (optionally async) checkpoints of ``(params, opt_state)``,
  * retry/restore on transient failures (``StepGuard``),
  * a straggler watch (EWMA step times),
  * optional injected faults (``inject_fault``) for recovery drills.

A step takes the loss and every gradient before its in-place update
(:func:`repro_torch.optim.make_train_step`); a fault is injected before
the step runs, so a retried step applies once.  GCN aggregates on B4
forward and backward (its transpose built once with the graph).

``Session.train()`` calls it for specs with a ``train`` section; the
module entry point is a deprecated shim that builds the equivalent
train-only RunSpec:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gcn-cora \\
      --steps 50 --ckpt-dir /tmp/ckpt --ckpt-every 20 --device cpu

prefer ``python -m repro_torch run spec.json``.
"""

from __future__ import annotations

import argparse
import time
from typing import Any, Dict

import torch

from repro_torch.device import DeviceLike, resolve_device


def _on(batch: Dict, device: torch.device) -> Dict[str, torch.Tensor]:
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def build_lm_job(arch: str, cfg, batch: int, seq: int, device: torch.device):
    from repro_torch.data.lm import LMDataConfig, sample_batch
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw, linear_warmup_cosine

    opt = adamw(linear_warmup_cosine(3e-4, 20, 2000))
    step_fn = tfm.make_train_step(cfg, opt)
    gen = torch.Generator(device=device).manual_seed(0)
    params = tfm.Transformer(cfg, generator=gen, device=device, use_kernel=False).param_tree()
    dcfg = LMDataConfig(vocab=cfg.vocab, batch=batch, seq_len=seq)
    return params, opt.init(params), step_fn, lambda step: _on(sample_batch(dcfg, step), device)


def build_gnn_job(arch: str, spec, device: torch.device):
    from repro_torch.api.spec import SpecError
    from repro_torch.configs.cells import _masked_ce
    from repro_torch.core import symmetric_normalize
    from repro_torch.data.graphs import planted_partition_graph
    from repro_torch.graph.structures import EdgeList
    from repro_torch.models import gnn as gnn_mod
    from repro_torch.optim import adamw, make_train_step

    cfg = spec.reduced_config
    is_gat = isinstance(cfg, gnn_mod.GATConfig)
    if not (is_gat or isinstance(cfg, gnn_mod.GCNConfig)):
        raise SpecError(f"train.arch: {arch} ({type(cfg).__name__}) has no node-classification "
                        "job; the job trains the GCN and GAT configs")
    n = 512
    data = planted_partition_graph(n_nodes=n, n_edges=2048, n_classes=cfg.n_classes,
                                   d_feat=cfg.d_feat, seed=0, device=device)
    el = EdgeList.from_dense(symmetric_normalize(data.edges.to_dense()))
    src, dst, w = (torch.from_numpy(a).to(device) for a in (el.src, el.dst, el.weights()))
    feats = torch.from_numpy(data.feats).to(device)
    labels = torch.from_numpy(data.labels).to(device)
    mask = torch.from_numpy(data.train_mask.astype("float32")).to(device)
    gen = torch.Generator(device=device).manual_seed(0)
    if is_gat:
        params = gnn_mod.GAT(cfg, generator=gen, device=device).param_tree()

        def logits_of(p):
            return gnn_mod.gat_forward(p, feats, src, dst, n)
    else:
        params = gnn_mod.GCN(cfg, generator=gen, device=device).param_tree()
        op = gnn_mod.csr_operator(src, dst, w, n)  # once per graph, the transpose beside it

        def logits_of(p):
            return gnn_mod.gcn_forward_csr(p, feats, op.nbr, op.wgt, op.live, op.transpose)

    opt = adamw(1e-2)
    step = make_train_step(lambda p, _: _masked_ce(logits_of(p), labels, mask), opt)
    return params, opt.init(params), step, lambda s: None


def build_recsys_job(arch: str, spec, batch: int, device: torch.device):
    from repro_torch.data.recsys import CTRDataConfig, sample_ctr_batch
    from repro_torch.models import recsys as rec
    from repro_torch.optim import adamw

    cfg = spec.reduced_config
    opt = adamw(1e-3)
    gen = torch.Generator(device=device).manual_seed(0)
    params = rec.WideDeep(cfg, generator=gen, device=device).param_tree()
    dcfg = CTRDataConfig(n_sparse=cfg.n_sparse, n_dense=cfg.n_dense,
                         vocab_per_field=cfg.vocab_per_field)
    return (params, opt.init(params), rec.make_train_step(cfg, opt),
            lambda step: _on(sample_ctr_batch(dcfg, batch, step), device))


def run_training(spec, *, echo=print, device: DeviceLike = None) -> Dict[str, Any]:
    """Execute a :class:`~repro_torch.api.spec.TrainSpec` on ``device``
    (``None``: ``cuda:0``); returns the loop's stats.

    ``echo`` receives the progress lines.  Raises
    :class:`~repro_torch.api.spec.SpecError` for lp-family archs: those
    converge through the ``solve`` section, not SGD.
    """
    from repro_torch.api.spec import SpecError
    from repro_torch.configs import get_arch
    from repro_torch.ft import FailureInjector, StepGuard, StragglerWatch
    from repro_torch.optim import OptState

    arch = get_arch(spec.arch)
    if arch.family not in ("lm", "gnn", "recsys"):
        raise SpecError(
            f"train.arch: family {arch.family!r} trains via the solve "
            "section (python -m repro_torch solve) instead"
        )
    dev = resolve_device(device)
    if arch.family == "lm":
        cfg = arch.full_config if spec.full else arch.reduced_config
        params, state, step_fn, next_batch = build_lm_job(spec.arch, cfg, spec.batch,
                                                          spec.seq, dev)
    elif arch.family == "gnn":
        params, state, step_fn, next_batch = build_gnn_job(spec.arch, arch, dev)
    else:
        params, state, step_fn, next_batch = build_recsys_job(spec.arch, arch, spec.batch, dev)

    ckpt = None
    start_step = 0
    resumed = False
    if spec.ckpt_dir:
        from repro_torch.checkpoint import CheckpointManager

        ckpt = CheckpointManager(spec.ckpt_dir, keep_last=3, async_write=spec.ckpt_async)
        restored_step, restored = ckpt.restore_latest((params, state))
        if restored is not None:
            params, state = restored[0], OptState(*restored[1])
            start_step = restored_step + 1
            resumed = True
            echo(f"[train] resumed from step {restored_step}")

    injector = FailureInjector(fail_at=tuple(spec.inject_fault))
    watch = StragglerWatch()

    # restore-replay closure for StepGuard
    snapshot = {"step": start_step, "params": params, "state": state}

    def restore():
        if ckpt is not None:
            s, restored = ckpt.restore_latest((snapshot["params"], snapshot["state"]))
            if restored is not None:
                snapshot["params"], snapshot["state"] = restored[0], OptState(*restored[1])
                snapshot["step"] = s + 1
                echo(f"[train] restored from checkpoint step {s}")
        return snapshot["step"], (snapshot["params"], snapshot["state"])

    guard = StepGuard(max_retries=2, restore_fn=restore)

    step = start_step
    losses = []
    while step < spec.steps:
        batch = next_batch(step)
        t0 = time.time()

        def run_one():
            injector.maybe_fail(step)
            return step_fn(snapshot["params"], snapshot["state"], batch)

        p, s, loss = guard.run(run_one)
        snapshot["params"], snapshot["state"] = p, s
        loss = float(loss)
        losses.append(loss)
        dt = time.time() - t0
        slow = watch.observe(dt)
        if step % spec.log_every == 0 or step == spec.steps - 1:
            echo(f"[train] step {step} loss {loss:.4f} ({dt*1e3:.0f} ms{' SLOW' if slow else ''})")
        if ckpt is not None and (step + 1) % spec.ckpt_every == 0:
            ckpt.save(step, (snapshot["params"], snapshot["state"]), metadata={"loss": loss})
        step += 1
        snapshot["step"] = step

    if ckpt is not None:
        ckpt.save(spec.steps - 1, (snapshot["params"], snapshot["state"]))
        ckpt.wait()
    if losses:
        echo(
            f"[train] done: first loss {losses[0]:.4f} → last "
            f"{losses[-1]:.4f}; retries={guard.retries} "
            f"restores={guard.restores} slow_steps={watch.slow_steps}"
        )
    return {
        "arch": spec.arch,
        "family": arch.family,
        "steps": len(losses),
        "first_loss": losses[0] if losses else float("nan"),
        "last_loss": losses[-1] if losses else float("nan"),
        "retries": guard.retries,
        "restores": guard.restores,
        "slow_steps": watch.slow_steps,
        "resumed": resumed,
    }


def main() -> None:
    """Deprecated CLI shim: builds the equivalent train-only RunSpec and
    runs it through ``Session.train()`` (no results/ writes)."""
    import warnings

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--full", action="store_true",
                    help="use the FULL config (default: reduced)")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--ckpt-async", action="store_true")
    ap.add_argument("--inject-fault", type=int, nargs="*", default=[])
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without CUDA) or cpu")
    args = ap.parse_args()

    warnings.warn(
        "python -m repro_torch.launch.train is a shim; use a RunSpec with a "
        "'train' section (python -m repro_torch run) instead",
        DeprecationWarning,
        stacklevel=2,
    )
    from repro_torch.api import RunSpec, Session, SpecError, TrainSpec

    try:
        spec = RunSpec(
            train=TrainSpec(
                arch=args.arch,
                steps=args.steps,
                batch=args.batch,
                seq=args.seq,
                full=args.full,
                ckpt_dir=args.ckpt_dir,
                ckpt_every=args.ckpt_every,
                ckpt_async=args.ckpt_async,
                inject_fault=tuple(args.inject_fault),
                log_every=args.log_every,
            )
        )
        art = Session(spec, device=args.device).train(echo=lambda msg: print(msg, flush=True))
    except SpecError as e:
        print(f"[train] {e}")
        raise SystemExit(2)
    print(f"[train] artifact: {art.kind} run_id={art.run_id}")


if __name__ == "__main__":
    main()
