"""End-to-end training example: train a reduced LM with checkpointing to
the ENDURE-tuned store, then "kill and resume" — the port of
``examples/train_lm.py``.

    PYTHONPATH=src python -m repro_torch.train_lm --device cpu
    PYTHONPATH=src python -m repro_torch.train_lm --steps 200   # the card

It prints what the reference example prints, and the step that phase 2
started from: phase 2 creates a new ``CheckpointStore`` on the directory,
whose manifest starts empty (as the reference's does), so it finds no
checkpoint and trains from step 0.
"""

import argparse
import shutil
import tempfile

import numpy as np

from .launch.train import TrainConfig, train_loop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    ckpt = tempfile.mkdtemp(prefix="repro_ckpt_")
    try:
        # Phase 1: train, "crash" at 60% of the way.
        crash_at = max(2, int(args.steps * 0.6))
        print(f"=== phase 1: train to step {crash_at}, then 'crash' ===")
        out1 = train_loop(args.arch, reduced=True, steps=crash_at,
                          ckpt_dir=ckpt, seq_len=args.seq_len,
                          global_batch=args.global_batch,
                          tc=TrainConfig(ckpt_interval=10),
                          device=args.device)
        # Phase 2: resume from the durable checkpoint + data cursor.
        print("=== phase 2: resume from checkpoint ===")
        out2 = train_loop(args.arch, reduced=True, steps=args.steps,
                          ckpt_dir=ckpt, resume=True, seq_len=args.seq_len,
                          global_batch=args.global_batch,
                          tc=TrainConfig(ckpt_interval=25),
                          device=args.device)
        print(f"phase 2 started at step {out2['start']} (its new store's "
              "manifest is empty)")
        first = np.mean(out1["losses"][:10])
        last = np.mean(out2["losses"][-10:])
        print(f"loss: first-10 avg {first:.4f} -> last-10 avg {last:.4f} "
              f"({'improved' if last < first else 'NOT improved'})")
        st = out2["store"].manifest.stats
        print(f"manifest LSM engine: {st.queries['w']} puts, "
              f"{st.comp_pages_written} pages written "
              f"(shape: {out2['store'].manifest.shape()})")
    finally:
        shutil.rmtree(ckpt, ignore_errors=True)


if __name__ == "__main__":
    main()
