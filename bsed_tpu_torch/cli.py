"""Unified CLI of the PyTorch port: the parser of ``bsed_tpu/cli.py``,
with its eleven subcommands and their flags.

    python -m bsed_tpu_torch.cli train --preset baseline_mt_isp --perf ...
    python -m bsed_tpu_torch.cli train --store-dir stored_data/<name> --resume
    python -m bsed_tpu_torch.cli eval --store-dir stored_data/<name> [--psds-sweep]
    python -m bsed_tpu_torch.cli export --store-dir ... --out model.pt
    python -m bsed_tpu_torch.cli features --store-dir ... --out-dir feats/

``train``, ``eval``, ``export`` and ``features`` run on the card unless
``--device cpu`` asks for the CPU; without ``--data-root`` they run on
deterministic synthetic fixtures. The other seven (``predict``,
``tag-train``, ``pseudo-label``, ``visualize``, ``preprocess``,
``synthesize``, ``analyze``) exit non-zero naming the ROADMAP item that
ports them. Flags mirror the reference argparse surface
(main_baseline.py:609-632): ``-fpn``/``--use-fpn``, ``-mt``/
``--meanteacher``, ``-ISP``, ``-stage``, ``-level``, ``-s/--subpart-data``.
"""
from __future__ import annotations

import argparse
import csv
import dataclasses
import os
import sys

# ROADMAP.md items that port the subcommands not ported yet
_NOT_PORTED = {"predict": "10", "tag-train": "8b", "pseudo-label": "8b",
               "visualize": "10", "preprocess": "10", "synthesize": "10",
               "analyze": "10"}


def _resolve_config(args, allow_store: bool = True):
    """Config resolution order (checkpoint-self-describing eval,
    TestModel.py:34-120 semantics):
      1. an explicit --preset always wins;
      2. else, when ``allow_store``, a --store-dir whose meta.json carries
         the full saved config rebuilds the training-time Config exactly
         (incl. audio geometry and model topology) — no flags needed;
      3. else, the default preset.
    ``cmd_train`` passes allow_store only when RESUMING: a fresh train into
    a reused store-dir must not silently inherit the previous run's
    experiment config from its stale meta.json."""
    from bsed_tpu_torch.config import config_from_dict, get_config

    if getattr(args, "preset", None):
        return get_config(args.preset)
    store = getattr(args, "store_dir", None)
    if store and allow_store and os.path.isdir(store):
        from bsed_tpu_torch.utils.checkpoint import CheckpointManager
        try:
            meta = CheckpointManager(store).load_meta()
        except FileNotFoundError:
            meta = {}
        if "config" in meta:
            return config_from_dict(meta["config"])
    return get_config("baseline")


def _apply_flags(cfg, args):
    from bsed_tpu_torch.config import perf_config

    if getattr(args, "tiny_audio", False):
        # smoke-test scale: 2 s clips at a reduced rate (CI / fixtures)
        from bsed_tpu_torch.config import AudioConfig
        cfg = dataclasses.replace(cfg, audio=AudioConfig(
            sr=3200, hop_size=160, max_len_seconds=2.0))
    model = dataclasses.replace(cfg.model, use_fpn=args.use_fpn
                                if args.use_fpn else cfg.model.use_fpn)
    train = cfg.train
    if args.meanteacher or args.isp:
        # reference semantics: -ISP implies the mean teacher
        # (main_baseline.py:637-639)
        train = dataclasses.replace(train, mean_teacher=True,
                                    isp=args.isp or train.isp)
    if args.stage:
        train = dataclasses.replace(train, stage=args.stage)
    da = cfg.da
    if args.level:
        da = dataclasses.replace(da, level=args.level)
    cfg = dataclasses.replace(cfg, model=model, train=train, da=da)
    if getattr(args, "perf", False):
        # throughput configuration: bf16 conv stack + train-mode folded
        # stem + fused stem-epilogue kernels + fused student/teacher
        # streams (pooled-BN semantics, hence opt-in)
        cfg = perf_config(cfg)
    return cfg


def _datasets(cfg, args):
    """(syn, weak, unlabeled, val) datasets — real feature dumps under
    --data-root, deterministic synthetic fixtures otherwise so every command
    is runnable without shipped data."""
    from bsed_tpu_torch.data.codec import ManyHotEncoder
    from bsed_tpu_torch.data.datasets import (NpyFeatureDataset,
                                              PseudoLabeledDataset,
                                              SyntheticDataSource)

    codec = ManyHotEncoder(cfg.bird_list, n_frames=cfg.n_frames,
                           sr=cfg.audio.sr, hop_size=cfg.audio.hop_size,
                           pooling_time_ratio=cfg.model.pooling_time_ratio)
    root = args.data_root
    if root is None:
        n = args.subpart_data or 64
        syn = SyntheticDataSource(cfg, n_items=n, seed=1)
        weak = SyntheticDataSource(cfg, n_items=n // 2, seed=2)
        unlab = SyntheticDataSource(cfg, n_items=n // 2, seed=3)
        val = SyntheticDataSource(cfg, n_items=max(8, n // 4), seed=4)
    else:
        syn = NpyFeatureDataset(
            os.path.join(root, cfg.data.synth_root,
                         cfg.data.synth_feature_subdir), codec, cfg)
        weak = NpyFeatureDataset(
            os.path.join(root, cfg.data.dataset_root,
                         cfg.data.train_weak_subdir), codec, cfg)
        pl_tsv = getattr(args, "pseudo_labels", None)
        if pl_tsv and not os.path.exists(pl_tsv):
            # an explicitly requested TSV must exist — silently training
            # with all-empty weak targets would be a trap
            sys.exit(f"error: pseudo-label TSV not found: {pl_tsv}")
        pl_tsv = pl_tsv or cfg.data.pseudo_label_tsv
        unlab = PseudoLabeledDataset(
            os.path.join(root, cfg.data.dataset_root,
                         cfg.data.train_unlabeled_subdir),
            pl_tsv, codec, cfg)
        val = NpyFeatureDataset(
            os.path.join(root, cfg.data.dataset_root, cfg.data.val_subdir),
            codec, cfg)
    return syn, weak, unlab, val


def _dataset_loaders(cfg, args):
    """(train, val, syn-eval) loaders on ``--device``: on the card the
    datasets' arrays are resident there (below 4 GiB), so ``train
    --scan-epoch auto`` runs each epoch on the resident path."""
    from bsed_tpu_torch.data.pipeline import EvalLoader, ThreeStreamLoader

    syn, weak, unlab, val = _datasets(cfg, args)
    # the origin lineage trains on the COMBINED real batch (¼ weak +
    # ½ unlabeled + ¼ syn-strong rows, main.py:729-741)
    layout = ("origin" if cfg.train.isp and
              cfg.train.isp_flavor == "origin" else "default")
    train_loader = ThreeStreamLoader(syn, weak, unlab,
                                     batch_size=cfg.train.batch_size,
                                     seed=cfg.train.seed, layout=layout,
                                     device=args.device)
    val_loader = EvalLoader(val, batch_size=cfg.train.batch_size,
                            device=args.device)
    syn_eval = EvalLoader(syn, batch_size=cfg.train.batch_size,
                          device=args.device)
    return train_loader, val_loader, syn_eval


def cmd_train(args):
    from bsed_tpu_torch.train.trainer import Trainer

    if args.resume and args.start_epoch == 0:
        # auto-resume: continue after the newest epoch checkpoint in the
        # store (the reference's recovery is editing start_epoch in-source,
        # main_baseline.py:649)
        from bsed_tpu_torch.utils.checkpoint import CheckpointManager
        if args.store_dir and os.path.isdir(args.store_dir):
            latest = CheckpointManager(args.store_dir).latest_epoch()
            if latest is not None:
                args.start_epoch = latest + 1
                print(f"# --resume: continuing from epoch {args.start_epoch}"
                      f" (newest checkpoint epoch_{latest})")
    cfg = _apply_flags(
        _resolve_config(args, allow_store=args.start_epoch > 0), args)
    train_loader, val_loader, syn_eval = _dataset_loaders(cfg, args)
    # --mesh: one device either way (data parallelism is ROADMAP item 9)
    trainer = Trainer(cfg, train_loader, val_loader=val_loader,
                      syn_eval_loader=syn_eval if args.eval_syn else None,
                      store_dir=args.store_dir,
                      use_tensorboard=args.tensorboard,
                      profile_dir=args.profile_dir,
                      grad_flow=args.grad_flow,
                      scan_epoch=args.scan_epoch,
                      device=args.device)
    best = trainer.fit(n_epochs=args.epochs, start_epoch=args.start_epoch)
    print(best)
    return best


def cmd_eval(args):
    from bsed_tpu_torch.eval.test_model import evaluate_checkpoint

    cfg = _apply_flags(_resolve_config(args), args)
    _, val_loader, _ = _dataset_loaders(cfg, args)
    results = evaluate_checkpoint(
        cfg, val_loader, store_dir=args.store_dir,
        torch_ckpt=args.torch_checkpoint, tag=args.tag,
        learned_post=args.learned_post,
        confusion_csv=args.confusion_csv, device=args.device)
    if args.psds_sweep:
        results.update(_psds_sweep(cfg, args, val_loader))
    print({k: v for k, v in results.items() if k != "per_class_f1"})
    return results


def _load_eval_params(cfg, args):
    """(modules, params, batch_stats) from a store-dir tag or a torch
    pickle; inference needs no train-step support check, so the modules
    are built directly."""
    from bsed_tpu_torch.eval.test_model import load_params
    from bsed_tpu_torch.train.steps import TrainModules
    from bsed_tpu_torch.utils.device import resolve_device

    params, stats = load_params(
        cfg, args.store_dir, getattr(args, "torch_checkpoint", None),
        getattr(args, "tag", "best"))
    return TrainModules(cfg, resolve_device(args.device)), params, stats


def _psds_sweep(cfg, args, val_loader):
    """Multi-OP PSDS report at (0,0)/(1,0)/(0,1) + ROC curve dump
    (evaluation_measures.py:287-315)."""
    import numpy as np

    from bsed_tpu_torch.data.codec import ManyHotEncoder
    from bsed_tpu_torch.eval.decode import (groundtruth_df_from_events,
                                            gt_events_from_frame_targets)
    from bsed_tpu_torch.eval.operating_points import (default_thresholds,
                                                      sweep_operating_points)
    from bsed_tpu_torch.eval.psds import compute_psds
    from bsed_tpu_torch.train.steps import make_predict_fn

    modules, params, stats = _load_eval_params(cfg, args)
    predict = make_predict_fn(modules)

    # GT at original second resolution when the dataset provides it;
    # otherwise decode the frame targets (like evaluate_checkpoint)
    true_events = val_loader.groundtruth_events()
    gt_events = dict(true_events) if true_events is not None else {}
    codec = ManyHotEncoder(cfg.bird_list, n_frames=cfg.n_frames,
                           sr=cfg.audio.sr, hop_size=cfg.audio.hop_size,
                           pooling_time_ratio=cfg.model.pooling_time_ratio)

    def batches():
        for mel, target, names, n_valid in val_loader:
            strong, _ = predict(params, stats, mel,
                                inference=cfg.model.use_fpn)
            if true_events is None:
                target = np.asarray(target)[:n_valid]
                if target.ndim == 3:
                    gt_events.update(gt_events_from_frame_targets(
                        target, names[:n_valid], codec, cfg))
            yield strong[:n_valid], names[:n_valid]

    # run the forward pass first so gt_events is fully populated before
    # the operating points are scored
    collected = list(batches())
    gt_df = groundtruth_df_from_events(gt_events)
    sweep = sweep_operating_points(
        iter(collected), cfg, gt_df,
        thresholds=default_thresholds(args.n_thresholds))
    report = dict(sweep["psds"])
    if args.roc_out:
        os.makedirs(args.roc_out, exist_ok=True)
        for name, a_ct, a_st in (("psds_ct0_st0", 0.0, 0.0),
                                 ("psds_ct1_st0", 1.0, 0.0),
                                 ("psds_ct0_st1", 0.0, 1.0)):
            res = compute_psds(sweep["operating_points"],
                               sweep["total_duration_s"],
                               alpha_ct=a_ct, alpha_st=a_st)
            with open(os.path.join(args.roc_out, f"roc_{name}.csv"), "w",
                      newline="") as fh:
                writer = csv.writer(fh, lineterminator="\n")
                writer.writerow(["efpr", "etpr"])
                writer.writerows(zip(res.efpr, res.etpr))
            try:  # ROC plot files (evaluation_measures.py:304-311)
                import matplotlib
                matplotlib.use("Agg")
                import matplotlib.pyplot as plt
            except ImportError:
                continue
            fig, ax = plt.subplots()
            ax.step(res.efpr, res.etpr, where="post")
            ax.set_xlabel("eFPR (per hour)")
            ax.set_ylabel("eTPR")
            ax.set_title(f"{name}: PSDS={res.value:.4f}")
            fig.savefig(os.path.join(args.roc_out, f"roc_{name}.png"),
                        dpi=120)
            plt.close(fig)
    return report


def cmd_features(args):
    """Encoder-embedding dumper (save_features.py:235-283)."""
    from bsed_tpu_torch.data.pipeline import EvalLoader
    from bsed_tpu_torch.eval.features import dump_features, make_encode_fn

    cfg = _apply_flags(_resolve_config(args), args)
    syn, weak, unlab, val = _datasets(cfg, args)
    split = {"syn": syn, "weak": weak, "unlabeled": unlab,
             "val": val}[args.split]
    loader = EvalLoader(split, batch_size=cfg.train.batch_size,
                        device=args.device)
    modules, params, stats = _load_eval_params(cfg, args)
    paths = dump_features(make_encode_fn(modules, params, stats), loader,
                          args.out_dir)
    print({"batches": len(paths), "out_dir": args.out_dir})
    return paths


def cmd_export(args):
    """Export a trained checkpoint as a reference-format torch pickle so the
    reference's own tooling (TestModel.py) can evaluate/resume it — the
    inverse of `eval --torch-checkpoint`."""
    from bsed_tpu_torch.eval.test_model import export_torch_checkpoint

    cfg = _apply_flags(_resolve_config(args), args)
    _modules, params, stats = _load_eval_params(cfg, args)
    path = export_torch_checkpoint(cfg, params, stats, args.out,
                                   epoch=args.epoch)
    print(f"wrote reference-format checkpoint -> {path}")
    return path


def cmd_not_ported(args):
    item = _NOT_PORTED[args.command]
    sys.exit(f"error: `{args.command}` is not ported to bsed_tpu_torch yet "
             f"(ROADMAP.md, open item {item}); `python -m bsed_tpu.cli "
             f"{args.command}` runs it on JAX")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="bsed_tpu_torch",
                                description="bird-SED framework, PyTorch "
                                            "port (CUDA)")
    sub = p.add_subparsers(dest="command", required=True)

    def common(sp):
        sp.add_argument("--preset", default=None,
                        help="named preset; omitted: rebuilt from the "
                             "store-dir's meta.json when present")
        sp.add_argument("--data-root", default=None)
        sp.add_argument("--store-dir", default=None)
        sp.add_argument("-s", "--subpart-data", type=int, default=None,
                        dest="subpart_data")
        sp.add_argument("-fpn", "--use-fpn", action="store_true")
        sp.add_argument("-mt", "--meanteacher", action="store_true")
        sp.add_argument("-ISP", "--ISP", dest="isp", action="store_true")
        sp.add_argument("-stage", "--stage",
                        choices=["pretrain", "adaptation"], default=None)
        sp.add_argument("-level", "--level", choices=["clip", "frame"],
                        default=None)
        sp.add_argument("--pseudo-labels", default=None)
        sp.add_argument("--tiny-audio", action="store_true",
                        help=argparse.SUPPRESS)
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default: the card; "
                             "'cpu' runs the kernels' plain versions)")

    sp = sub.add_parser("train")
    sp.add_argument("--perf", action="store_true",
                    help="throughput config: bf16 + folded train stem + "
                         "fused stem-epilogue kernels + fused streams "
                         "(pooled-BN semantics)")
    common(sp)
    sp.add_argument("--epochs", type=int, default=None)
    sp.add_argument("--start-epoch", type=int, default=0)
    sp.add_argument("--resume", action="store_true",
                    help="continue after the newest epoch checkpoint in "
                         "--store-dir (no-op when the store is empty)")
    sp.add_argument("--eval-syn", action="store_true")
    sp.add_argument("--tensorboard", action="store_true")
    sp.add_argument("--profile-dir", default=None,
                    help="capture a torch.profiler trace of the first "
                         "trained epoch into this directory")
    sp.add_argument("--grad-flow", action="store_true",
                    help="per-parameter mean-|grad| metrics + "
                         "gradient_flow.png per epoch "
                         "(plot_grad_flow, main_baseline.py:108-123)")
    sp.add_argument("--mesh", choices=("auto", "off"), default="auto",
                    help="accepted for bsed_tpu's command lines; both train "
                         "on one device (data parallelism: ROADMAP item 9)")
    sp.add_argument("--scan-epoch", choices=("auto", "off"), default="auto",
                    help="'auto' (default): when the dataset is resident "
                         "on the device, run each epoch with no wait on the "
                         "device inside it; 'off': the prefetching loop")
    sp.set_defaults(fn=cmd_train)

    sp = sub.add_parser("eval")
    common(sp)
    sp.add_argument("--tag", default="best")
    sp.add_argument("--torch-checkpoint", default=None)
    sp.add_argument("--learned-post", action="store_true")
    sp.add_argument("--confusion-csv", default=None)
    sp.add_argument("--psds-sweep", action="store_true",
                    help="multi-threshold PSDS report at (0,0)/(1,0)/(0,1)")
    sp.add_argument("--n-thresholds", type=int, default=50)
    sp.add_argument("--roc-out", default=None,
                    help="directory for ROC curve CSV/PNG dumps")
    sp.set_defaults(fn=cmd_eval)

    sp = sub.add_parser("export",
                        help="store-dir checkpoint -> reference torch pickle")
    common(sp)
    sp.add_argument("--tag", default="best")
    sp.add_argument("--torch-checkpoint", default=None)
    sp.add_argument("--out", required=True)
    sp.add_argument("--epoch", type=int, default=0)
    sp.set_defaults(fn=cmd_export)

    sp = sub.add_parser("predict",
                        help="raw audio (wav/npy) -> decoded event TSV")
    common(sp)
    sp.add_argument("--audio", nargs="+", required=True,
                    help="wav or raw-audio .npy file(s), any length")
    sp.add_argument("--out-tsv", required=True)
    sp.add_argument("--tag", default="best")
    sp.add_argument("--torch-checkpoint", default=None)
    sp.add_argument("--threshold", type=float, default=0.5)
    sp.add_argument("--learned-post", action="store_true",
                    help="class-wise median windows instead of the fixed one")
    sp.add_argument("--hop-seconds", type=float, default=None,
                    help="window hop for long recordings (default: one clip)")
    sp.add_argument("--batch-size", type=int, default=32)
    sp.add_argument("--precision", default="high",
                    choices=["highest", "high", "fast"])
    sp.set_defaults(fn=cmd_not_ported)

    sp = sub.add_parser("tag-train",
                        help="train the weak audio tagger (cycle step 1)")
    common(sp)
    sp.add_argument("--arch", choices=["resnet", "vgg"], default="resnet")
    sp.add_argument("--epochs", type=int, default=1)
    sp.add_argument("--save", default=None,
                    help="path for the best tagger weights")
    sp.add_argument("--weights-file", default=None,
                    help="torchvision resnet18 state_dict pickle for "
                         "pretrained initialization")
    sp.set_defaults(fn=cmd_not_ported)

    sp = sub.add_parser("pseudo-label",
                        help="write the weak pseudo-label TSV (cycle step 2)")
    common(sp)
    sp.add_argument("--arch", choices=["resnet", "vgg"], default="resnet")
    sp.add_argument("--weights", required=True)
    sp.add_argument("--out-tsv", required=True)
    sp.add_argument("--threshold", type=float, default=0.5)
    sp.set_defaults(fn=cmd_not_ported)

    sp = sub.add_parser("features",
                        help="dump (B, 313, 256) encoder embeddings")
    common(sp)
    sp.add_argument("--tag", default="best")
    sp.add_argument("--torch-checkpoint", default=None)
    sp.add_argument("--split", choices=["syn", "weak", "unlabeled", "val"],
                    default="val")
    sp.add_argument("--out-dir", required=True)
    sp.set_defaults(fn=cmd_features)

    sp = sub.add_parser("visualize",
                        help="t-SNE + SVM domain probes over feature dumps")
    sp.add_argument("--syn-features", required=True)
    sp.add_argument("--real-features", required=True)
    sp.add_argument("--out-dir", required=True)
    sp.set_defaults(fn=cmd_not_ported)

    sp = sub.add_parser("preprocess")
    sp.add_argument("--preset", default="baseline")
    sp.add_argument("--dataset-root", required=True)
    sp.add_argument("--no-split", action="store_true")
    sp.set_defaults(fn=cmd_not_ported)

    sp = sub.add_parser("synthesize")
    sp.add_argument("--preset", default="baseline")
    sp.add_argument("--co-occur", required=True)
    sp.add_argument("--out", required=True)
    sp.add_argument("--n-soundscapes", type=int, default=100)
    sp.add_argument("--fg-dir", default=None)
    sp.add_argument("--bg-dir", default=None)
    sp.add_argument("--features-out", default=None)
    sp.add_argument("--seed", type=int, default=2023)
    sp.set_defaults(fn=cmd_not_ported)

    sp = sub.add_parser("analyze")
    sp.add_argument("--preset", default="baseline")
    sp.add_argument("--annotation-dir", required=True)
    sp.add_argument("--out-dir", required=True)
    sp.set_defaults(fn=cmd_not_ported)

    return p


def main(argv=None):
    """Parse ``argv`` and run the subcommand; returns what it returns
    (``train``: the best epoch's row; ``eval``: the scores)."""
    args = build_parser().parse_args(argv)
    try:
        return args.fn(args)
    except KeyError as e:
        from bsed_tpu_torch.config import PRESETS
        if str(e).strip("'") in (getattr(args, "preset", "") or ""):
            sys.exit(f"error: unknown preset {e}; available: "
                     f"{', '.join(sorted(PRESETS))}")
        raise
    except FileNotFoundError as e:
        sys.exit(f"error: {e}")


if __name__ == "__main__":
    main()
