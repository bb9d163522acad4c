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
    python -m intrepppid_tpu_torch export torch_ckpt \
        --checkpoint_path logs/<run>/chkpt/<best> --out_path model.ckpt
    python -m intrepppid_tpu_torch data build --sequences_path seqs.fasta \
        --interactions_path itx.csv --orthologs_path og.csv --out_path DATASET.h5
    python -m intrepppid_tpu_torch data inspect --dataset_path DATASET.h5
    python -m intrepppid_tpu_torch data train_spm --input_path seqs.fasta \
        --out_path spm.model

Every group of the JAX CLI is ported. ``export`` and ``data`` run on the
host alone; ``data`` needs ``h5py`` to build or inspect a dataset.
"""
from __future__ import annotations


def main(argv=None):
    from intrepppid_tpu_torch.cli.data import Data
    from intrepppid_tpu_torch.cli.evaluate import Eval
    from intrepppid_tpu_torch.cli.export import Export
    from intrepppid_tpu_torch.cli.infer import Infer
    from intrepppid_tpu_torch.cli.parser import dispatch
    from intrepppid_tpu_torch.cli.serve import Serve
    from intrepppid_tpu_torch.cli.train import Train

    return dispatch({"train": Train(), "eval": Eval(), "serve": Serve(), "infer": Infer(),
                     "data": Data(), "export": Export()}, argv)


if __name__ == "__main__":
    main()
