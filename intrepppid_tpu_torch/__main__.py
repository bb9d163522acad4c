"""CLI entry point of the port:

    python -m intrepppid_tpu_torch train e2e_rnn_triplet DATASET.h5 spm.model 3 100 80 \
        [--device cuda]
    python -m intrepppid_tpu_torch eval e2e_rnn_triplet \
        --checkpoint_path logs/<run>/chkpt/<best> --ppi_dataset_path DATASET.h5 \
        --sentencepiece_path spm.model --c_type 3 [--device cuda]
    python -m intrepppid_tpu_torch serve start --weights_path model.ckpt \
        --spm_path spm.model [--device cuda]
    python -m intrepppid_tpu_torch infer from_csv --interactions_path pairs.csv \
        --sequences_path seqs.fasta --weights_path model.ckpt \
        --spm_path spm.model --out_path scores.csv [--device cuda]

``train``, ``eval``, ``serve`` and ``infer`` are ported; the JAX CLI's
``export`` and ``data`` groups are queued in ROADMAP.md (A3, A5).
"""
from __future__ import annotations


def main(argv=None):
    from intrepppid_tpu_torch.cli.evaluate import Eval
    from intrepppid_tpu_torch.cli.infer import Infer
    from intrepppid_tpu_torch.cli.parser import dispatch
    from intrepppid_tpu_torch.cli.serve import Serve
    from intrepppid_tpu_torch.cli.train import Train

    return dispatch({"train": Train(), "eval": Eval(), "serve": Serve(), "infer": Infer()},
                    argv)


if __name__ == "__main__":
    main()
