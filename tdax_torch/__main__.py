"""Command line of the port: the reference workflow's three steps.

  python -m tdax_torch generate                 # 48 images + metadata.json
  python -m tdax_torch extract                  # full Qwen-VL capture on the card
  python -m tdax_torch extract --toy            # tiny random model
  python -m tdax_torch extract --int8           # int8 weight-only matmuls
  python -m tdax_torch extract --device cpu     # on the CPU, when asked
  python -m tdax_torch sweep                    # per-layer UMAP + Rips + silhouettes
  python -m tdax_torch sweep --device cpu       # the sweep on the CPU

Without a checkpoint the model's weights are random (seed 0) and the
tokenizer is the byte-level ``ToyTokenizer``, as in tdax when no
checkpoint is present.  Outputs go to ``data/physics_experiment_6x6``
(``all_activations.pt`` and ``.npz``) relative to the working directory;
``sweep`` (the counterpart of ``debug_tda_pipeline.py``) reads them back
(the ``.npz`` when present) and writes ``tda_debug_output/``.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    parser = argparse.ArgumentParser(prog="python -m tdax_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    sub.add_parser("generate", help="write the 48-sample 6x6 dataset")
    ext = sub.add_parser("extract", help="capture per-layer last-token activations")
    ext.add_argument("--toy", action="store_true", help="tiny random-weights model")
    ext.add_argument("--int8", action="store_true",
                     help="int8 weight-only matmuls (weights drawn straight into int8)")
    ext.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: cuda)")
    swp = sub.add_parser("sweep", help="per-layer UMAP + Rips + silhouette sweep")
    swp.add_argument("--device", default=None, help="'cpu' to run on the CPU (default: cuda)")
    args = parser.parse_args(argv)

    from tdax_torch.config import DatasetConfig, ExtractConfig
    ds = DatasetConfig()
    if args.command == "generate":
        from tdax_torch.data.dataset import generate_dataset
        metadata = generate_dataset(ds)
        print(f"Generated {len(metadata)} samples in {ds.data_dir}")
        return
    if args.command == "sweep":
        import os

        from tdax_torch.config import SweepConfig
        from tdax_torch.data.io import load_activations
        from tdax_torch.pipeline.tda_sweep import run_tda_sweep
        from tdax_torch.runtime import get_device

        device = get_device(args.device)
        cfg = SweepConfig()
        npz = ds.activations_path.replace(".pt", ".npz")
        path = npz if os.path.exists(npz) else ds.activations_path
        print(f"Debug output will be saved to: {cfg.output_dir}")
        print(f"Loading activations from {path}...")
        run_tda_sweep(load_activations(path), ds.metadata_path, cfg, device=device)
        return

    from tdax_torch.data.io import load_metadata
    from tdax_torch.models.qwen_vl.config import QwenVLConfig
    from tdax_torch.pipeline.extract import extract_activations

    cfg = QwenVLConfig.tiny() if args.toy else QwenVLConfig()
    print(f"Loading metadata from {ds.metadata_path}...")
    metadata = load_metadata(ds.metadata_path)
    print(f"Extracting activations for {len(metadata)} samples "
          f"({'toy model' if args.toy else 'full model'}, random weights"
          f"{', int8' if args.int8 else ''})...")
    results = extract_activations(metadata, ds.activations_path, cfg,
                                  ExtractConfig(quantize_int8=args.int8), device=args.device)
    print(f"\nExtracted activations for {len(results)} samples.")


if __name__ == "__main__":
    main()
