"""CLI: score embedding CSVs into a tidy results table (counterpart of
:mod:`bvc_tpu.cli.evaluate_embeddings`, the same flags and output; the
probes are the port's numpy ones, :mod:`bvc_tpu_torch.evalbench.scores`).

Runnable replacement for ``notebooks/EvaluateEmbeddings.ipynb`` (cells
10-12): sweeps an embeddings folder (train CSVs + ``test/`` pairs, or
Toybox single-CSV mode), scores each run with a linear probe or kNN
retrieval, and writes/prints the tidy DataFrame the notebook builds
(columns: Curriculum, Stage, Condition, Seed, Train Groups, score,
Iteration).

Example::

    python -m bvc_tpu_torch.cli.evaluate_embeddings \
        -emb_root out/benchmarks/ssv2/ -ds_task ssv2 \
        --ssv2_train_labels labels/train_easy10.csv \
        --ssv2_test_labels labels/val_easy10.csv \
        --iter_per_stage 10000 --eval_type linear -o scores.csv
"""

from __future__ import annotations

import argparse


def build_parser():
    p = argparse.ArgumentParser(description="Score embedding CSVs (notebook replacement)")
    p.add_argument("-emb_root", type=str, required=True)
    p.add_argument("-ds_task", type=str, required=True,
                   help="ssv2|ucf101|cifar10|tb_cat|tb_trans")
    p.add_argument("--iter_per_stage", type=int, default=10000,
                   help="n_epoch*max_epoch_iters, for the Iteration column")
    p.add_argument("--eval_type", type=str, default="linear", help="linear|nn")
    p.add_argument("--n_jobs", type=int, default=8)
    p.add_argument("--tb_single_csv", action="store_true",
                   help="Toybox mode without a test/ folder (exemplar split)")
    p.add_argument("--exemplar", action="store_true",
                   help="Toybox: hold out exemplars instead of random rows")
    p.add_argument("--ssv2_train_labels", type=str, default="")
    p.add_argument("--ssv2_test_labels", type=str, default="")
    p.add_argument("-o", "--output", type=str, default="")
    return p


def main(argv=None):
    args = build_parser().parse_args(argv)
    from bvc_tpu_torch.evalbench.evaluators import proc_result_folder, proc_result_folder_tb

    kw = {}
    if args.ds_task == "ssv2":
        if not (args.ssv2_train_labels and args.ssv2_test_labels):
            raise SystemExit("ssv2 needs --ssv2_train_labels/--ssv2_test_labels")
        kw["label_paths"] = {
            "train": args.ssv2_train_labels, "test": args.ssv2_test_labels,
        }
    if args.ds_task in ("tb_cat", "tb_trans"):
        kw["exemplar"] = args.exemplar
    if args.tb_single_csv:
        df = proc_result_folder_tb(args.emb_root, args.ds_task,
                                   args.iter_per_stage, n_jobs=args.n_jobs,
                                   exemplar=args.exemplar)
    else:
        df = proc_result_folder(args.emb_root, args.ds_task,
                                args.iter_per_stage, eval_type=args.eval_type,
                                n_jobs=args.n_jobs, **kw)
    print(df.to_string(index=False))
    if args.output:
        df.to_csv(args.output, index=False)
        print(f"saved {args.output}")
    return df


if __name__ == "__main__":
    main()
