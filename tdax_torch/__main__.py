"""Command line of the port: the reference workflow, its adversarial
experiment, the peak layer's 3-D HTML and the legacy sweep.

  python -m tdax_torch generate                 # 48 images + metadata.json
  python -m tdax_torch extract                  # full Qwen-VL capture on the card
  python -m tdax_torch extract --model-dir DIR  # weights and tokenizer of a HF snapshot
  python -m tdax_torch extract --toy            # tiny random model
  python -m tdax_torch extract --int8           # int8 weight-only matmuls
  python -m tdax_torch extract --device cpu     # on the CPU, when asked
  torchrun --standalone --nproc-per-node 8 -m tdax_torch extract --toy --device cpu
                                                # dp over 8 ranks (gloo; NCCL on cards)
  python -m tdax_torch sweep                    # per-layer UMAP + Rips + silhouettes
  python -m tdax_torch sweep --device cpu       # the sweep on the CPU
  torchrun --standalone --nproc-per-node 4 -m tdax_torch sweep --device cpu
                                                # the layers split over 4 ranks (gloo)
  python -m tdax_torch adversarial-metadata     # the 720 adversarial pairs
  python -m tdax_torch extract --adversarial    # their capture
  python -m tdax_torch sweep --adversarial      # the 4-condition sweep
  python -m tdax_torch sweep --legacy           # one shared UMAP reducer, peak by max H1
  python -m tdax_torch visualize                # the peak layer's interactive 3-D HTML
  python -m tdax_torch visualize --peak-layer 25 --debug-dir tda-output --no-png

Under ``torchrun`` ``extract`` and ``sweep`` join the process group
torchrun set up (NCCL, ``cuda:LOCAL_RANK``; gloo with ``--device cpu``)
and split their work over its ranks, as tdax does over its devices:
``extract`` each rank's rows of every batch, ``sweep`` each rank's
share of the layers when the ranks divide them (else every rank runs
them all); rank 0 alone prints and writes the files.  ``extract`` takes its
weights from ``--model-dir`` (which must hold
checkpoint shards), else from ``./qwen-vl-chat-local`` when that holds
them (not with ``--toy``), else draws them at random (seed 0); the
tokenizer is the checkpoint's when the directory has one, else the
byte-level ``ToyTokenizer``, as in tdax.  It prints which weights it
used.  Files go to ``data/physics_experiment_6x6`` relative to the
working directory: ``all_activations.pt`` and ``.npz``, or with
``--adversarial`` ``adversarial_activations.pt`` and ``.npz`` (from
``adversarial_metadata.json``, checkpointed every 50 samples).
``sweep`` (the counterpart of ``debug_tda_pipeline.py``) reads them back
(the ``.npz`` when present) and writes ``tda_debug_output/``; with
``--adversarial`` (``analyze_adversarial_tda.py``) it writes
``tda_adversarial_output/``; with ``--legacy``
(``analyze_tda_over_layers.py``) it writes ``tda_legacy_output/`` and,
in the working directory, ``tda_evolution_bound_umap.png`` and
``peak_layer_<p>_diagram_umap.png`` (matplotlib).  ``visualize``
(``visualize_peak_layer.py``) reads ``<debug-dir>/point_clouds_3d``
(``tda_debug_output`` when the directory does not exist) and writes two
HTML files there, each with a PNG beside it unless ``--no-png``.
"""

from __future__ import annotations

import argparse
import os


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m tdax_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("generate", help="write the 48-sample 6x6 dataset")
    sub.add_parser("adversarial-metadata",
                   help="write the 720 adversarial image-text pairs of the bound images")
    ext = sub.add_parser("extract", help="capture per-layer last-token activations")
    ext.add_argument("--toy", action="store_true", help="tiny model")
    ext.add_argument("--int8", action="store_true", help="int8 weight-only matmuls")
    ext.add_argument("--model-dir", default=None,
                     help="HF snapshot to load the weights and tokenizer from")
    ext.add_argument("--adversarial", action="store_true",
                     help="capture the adversarial pairs instead of the dataset")
    ext.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: cuda)")
    swp = sub.add_parser("sweep", help="per-layer UMAP + Rips + silhouette sweep")
    mode = swp.add_mutually_exclusive_group()
    mode.add_argument("--adversarial", action="store_true",
                      help="the 4-condition sweep of the adversarial capture")
    mode.add_argument("--legacy", action="store_true",
                      help="one UMAP reducer shared by every layer, peak by max H1, "
                           "and its two plots")
    swp.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: cuda)")
    vis = sub.add_parser("visualize", help="interactive 3-D HTML of the peak layer's cloud")
    vis.add_argument("--peak-layer", type=int, default=25)
    vis.add_argument("--debug-dir", default="tda-output")
    vis.add_argument("--no-png", action="store_true",
                     help="write no PNG beside the HTML (needs no matplotlib)")
    args = parser.parse_args(argv)

    from tdax_torch.config import DatasetConfig
    from tdax_torch.data.io import load_metadata
    ds = DatasetConfig()
    if args.command == "generate":
        from tdax_torch.data.dataset import generate_dataset
        metadata = generate_dataset(ds)
        print(f"Generated {len(metadata)} samples in {ds.data_dir}")
        return
    if args.command == "adversarial-metadata":
        from tdax_torch.data.adversarial import condition_counts, generate_adversarial_metadata
        print(f"Loading base metadata from {ds.metadata_path}...")
        samples = generate_adversarial_metadata(load_metadata(ds.metadata_path), ds, save=True)
        print(f"\nGenerated {len(samples)} adversarial samples:")
        for cond, count in sorted(condition_counts(samples).items()):
            print(f"  {cond}: {count} samples")
        print(f"\nSaved to {ds.adversarial_metadata_path}")
        return
    if args.command == "visualize":
        from tdax_torch.pipeline.report import visualize_peak_layer
        visualize_peak_layer(args.peak_layer, args.debug_dir, ds.metadata_path,
                             png_fallback=not args.no_png)
        return

    run = _sweep if args.command == "sweep" else _extract
    from tdax_torch.parallel import mesh
    if mesh.launched_by_torchrun():
        device = mesh.init_distributed(args.device)
        try:  # the other ranks say nothing
            run(args, ds, device,
                say=print if int(os.environ["RANK"]) == 0 else lambda *a, **k: None)
        finally:
            mesh.shutdown()
    else:
        from tdax_torch.runtime import get_device
        run(args, ds, get_device(args.device), say=print)


def _extract(args, ds, device, say) -> None:
    from tdax_torch.config import ExtractConfig
    from tdax_torch.data.io import load_metadata
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.pipeline.extract import _has_checkpoint, extract_activations

    cfg = QwenVLConfig.tiny() if args.toy else QwenVLConfig()
    model_dir = args.model_dir or (None if args.toy else ExtractConfig.model_dir)
    ecfg = ExtractConfig(model_dir=model_dir, quantize_int8=args.int8)
    params = None
    if args.model_dir is not None:
        # an explicit directory must hold a checkpoint: the loader raises if not
        from tdax_torch.models.qwen_vl.convert import load_qwen_checkpoint
        params = load_qwen_checkpoint(args.model_dir, cfg, device, quantize=args.int8)
    weights = (f"the checkpoint in {model_dir}" if params is not None or _has_checkpoint(model_dir)
               else "random weights (seed 0)")
    meta_path, out_path = ((ds.adversarial_metadata_path, ds.adversarial_activations_path)
                           if args.adversarial else (ds.metadata_path, ds.activations_path))
    say(f"Loading metadata from {meta_path}...")
    metadata = load_metadata(meta_path)
    say(f"Extracting activations for {len(metadata)} samples "
        f"({'toy model' if args.toy else 'full model'}, {weights}"
        f"{', int8' if args.int8 else ''})...")
    results = extract_activations(metadata, out_path, cfg, ecfg, params=params, device=device)
    say(f"\nExtracted activations for {len(results)} samples.")


def _sweep(args, ds, device, say) -> None:
    from tdax_torch.config import SweepConfig
    from tdax_torch.data.io import load_activations

    pt = ds.adversarial_activations_path if args.adversarial else ds.activations_path
    npz = pt.replace(".pt", ".npz")
    path = npz if os.path.exists(npz) else pt
    say(f"Loading activations from {path}...")
    all_data = load_activations(path)
    if args.adversarial:
        from tdax_torch.data.adversarial import condition_counts
        from tdax_torch.pipeline.adversarial import run_adversarial_sweep
        say("\nSamples per condition:")
        for cond, cnt in sorted(condition_counts([e["metadata"]
                                                  for e in all_data.values()]).items()):
            say(f"  {cond}: {cnt} samples")
        run_adversarial_sweep(all_data, "tda_adversarial_output", SweepConfig(), device=device)
        return
    if args.legacy:
        from tdax_torch.pipeline.report import run_legacy_sweep
        run_legacy_sweep(all_data, ds.metadata_path, device=device)
        return
    from tdax_torch.pipeline.tda_sweep import run_tda_sweep
    cfg = SweepConfig()
    say(f"Debug output will be saved to: {cfg.output_dir}")
    run_tda_sweep(all_data, ds.metadata_path, cfg, device=device)


if __name__ == "__main__":
    main()
