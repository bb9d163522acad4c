"""Data layer (`intrepppid_tpu/data` counterpart): the tokenizer, the
INTREPPPID HDF5 quintuplet dataset and data module, the input pipeline, and
the legacy data modules the reference exports
(`intrepppid/data/__init__.py:17-18`): ``OmaTripletDataModule`` (``oma.py``,
CSV triplets), ``RapppidDataModule2`` (``ppi.py``, pairs) and
``IntrepppidDataModule2`` (``ppi_oma_lazy.py``, per-item HDF5 reads). The
SentencePiece trainer is ``spm/trainer.py``. Each module that reads HDF5
imports ``h5py`` inside the function that reads, so importing the package
needs none.
"""
from intrepppid_tpu_torch.data.oma import OmaTripletDataModule, OmaTripletDataset
from intrepppid_tpu_torch.data.pipeline import host_prefetch, prefetch_to_device
from intrepppid_tpu_torch.data.ppi import RapppidDataModule2, RapppidDataset2
from intrepppid_tpu_torch.data.ppi_oma import IntrepppidDataModule, IntrepppidDataset
from intrepppid_tpu_torch.data.ppi_oma_lazy import IntrepppidDataModule2, IntrepppidDataset2
from intrepppid_tpu_torch.data.tokenizer import (
    SentencePieceTokenizer,
    set_random_generator_seed,
)

__all__ = [
    "IntrepppidDataModule",
    "IntrepppidDataModule2",
    "IntrepppidDataset",
    "IntrepppidDataset2",
    "OmaTripletDataModule",
    "OmaTripletDataset",
    "RapppidDataModule2",
    "RapppidDataset2",
    "SentencePieceTokenizer",
    "host_prefetch",
    "prefetch_to_device",
    "set_random_generator_seed",
]
