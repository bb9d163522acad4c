"""CLI entry point of the port:

    python -m intrepppid_tpu_torch serve start --weights_path model.ckpt \
        --spm_path spm.model [--device cuda]

Only ``serve start`` is ported so far; the other groups of the JAX CLI are
queued in ROADMAP.md.
"""
from __future__ import annotations


def main(argv=None):
    from intrepppid_tpu_torch.cli.parser import dispatch
    from intrepppid_tpu_torch.cli.serve import Serve

    return dispatch({"serve": Serve()}, argv)


if __name__ == "__main__":
    main()
