"""CLI entry point of the port:

    python -m intrepppid_tpu_torch serve start --weights_path model.ckpt \
        --spm_path spm.model [--device cuda]
    python -m intrepppid_tpu_torch infer from_csv --interactions_path pairs.csv \
        --sequences_path seqs.fasta --weights_path model.ckpt \
        --spm_path spm.model --out_path scores.csv [--device cuda]

``serve`` and ``infer`` are ported so far; the other groups of the JAX CLI
are queued in ROADMAP.md.
"""
from __future__ import annotations


def main(argv=None):
    from intrepppid_tpu_torch.cli.parser import dispatch
    from intrepppid_tpu_torch.cli.infer import Infer
    from intrepppid_tpu_torch.cli.serve import Serve

    return dispatch({"serve": Serve(), "infer": Infer()}, argv)


if __name__ == "__main__":
    main()
