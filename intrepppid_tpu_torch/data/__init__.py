"""Data layer (`intrepppid_tpu/data` counterpart): the tokenizer, the
INTREPPPID HDF5 quintuplet dataset and data module, and the input pipeline.

Not yet ported (ROADMAP.md A5): the legacy data modules ``oma.py``
(``OmaTripletDataModule``), ``ppi.py`` (``RapppidDataModule2``),
``ppi_oma_lazy.py`` and the SentencePiece trainer ``spm/trainer.py``.
"""
from intrepppid_tpu_torch.data.pipeline import host_prefetch, prefetch_to_device
from intrepppid_tpu_torch.data.ppi_oma import IntrepppidDataModule, IntrepppidDataset
from intrepppid_tpu_torch.data.tokenizer import (
    SentencePieceTokenizer,
    set_random_generator_seed,
)

__all__ = [
    "IntrepppidDataModule",
    "IntrepppidDataset",
    "SentencePieceTokenizer",
    "host_prefetch",
    "prefetch_to_device",
    "set_random_generator_seed",
]
