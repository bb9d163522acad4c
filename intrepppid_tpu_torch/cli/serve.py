"""Serving CLI: ``python -m intrepppid_tpu_torch serve start``
(`intrepppid_tpu/cli/serve.py:18-114` counterpart).

Loads one reference-layout ``.ckpt`` (or a checkpoint directory of the
port's ``Trainer.fit``) and a SentencePiece model resident and
answers ``POST /score`` with pair probabilities. The network is always built
with ``use_projection=True``, as the reference's infer CLI does, in f32. It
runs on ``--device`` (default ``cuda``); there is no silent CPU fallback.
"""
from __future__ import annotations

from pathlib import Path
from typing import Optional

from intrepppid_tpu_torch.cli.infer import stream_fasta


class Serve:
    @staticmethod
    def start(
        weights_path: Path,
        spm_path: Path,
        host: str = "127.0.0.1",
        port: int = 8000,
        trunc_len: int = 1500,
        batch_size: int = 16,
        bulk_batch_size: int = 400,
        sampling: bool = False,
        vocab_size: int = 250,
        embedding_size: int = 64,
        rnn_num_layers: int = 2,
        bi_reduce: str = "last",
        max_pairs: int = 4096,
        warmup: bool = True,
        coalesce: bool = True,
        allow_reload: bool = False,
        sequences_path: Optional[Path] = None,
        token_cache_size: int = 65536,
        n_data_parallel: int = 1,
        device: str = "cuda",
        _block: bool = True,
    ):
        """Start the scoring server (blocks; Ctrl-C to stop).

        ``weights_path`` is a reference-layout ``.ckpt`` (what ``python -m
        intrepppid_tpu export torch_ckpt`` writes) or a checkpoint
        directory of the port's ``Trainer.fit``. ``--warmup`` (default
        on) runs one full batch of each batch rung at the largest length
        bucket before listening, so the first request does not pay the
        kernel build. ``--coalesce`` (default on) merges concurrent
        requests into shared device dispatches. ``--sequences_path``
        pre-tokenizes a FASTA into the token cache. ``--allow_reload``
        enables ``POST /reload``, which re-reads ``weights_path`` and swaps
        the weights in with zero downtime. ``--device`` picks the card
        (``cuda``, ``cuda:1``) or ``cpu``.
        """
        from intrepppid_tpu_torch.data.tokenizer import SentencePieceTokenizer
        from intrepppid_tpu_torch.models.factory import intrepppid_network
        from intrepppid_tpu_torch.serve import PPIServer, ScoringEngine
        from intrepppid_tpu_torch.utils.convert import load_reference_checkpoint

        spp = SentencePieceTokenizer(spm_path)
        spp.validate_vocab_size(vocab_size)
        net = intrepppid_network(
            0,
            vocab_size=vocab_size,
            embedding_size=embedding_size,
            rnn_num_layers=rnn_num_layers,
            bi_reduce=bi_reduce,
            use_projection=True,
            device=device,
        )

        def load():
            return load_reference_checkpoint(weights_path, rnn_num_layers)

        engine = ScoringEngine(
            net,
            load(),
            spp,
            trunc_len=trunc_len,
            batch_size=batch_size,
            bulk_batch_size=bulk_batch_size,
            sampling=sampling,
            token_cache_size=token_cache_size,
            n_data_parallel=n_data_parallel,
        )
        if sequences_path is not None:
            n = engine.preload(stream_fasta(sequences_path))
            print(f"preloaded {n} sequences into the token cache", flush=True)
        if warmup:
            engine.warmup()
        server = PPIServer(
            engine, host=host, port=port, max_pairs=max_pairs,
            coalesce=coalesce, reload_cb=load if allow_reload else None,
        )
        print(
            f"intrepppid_tpu_torch serving on http://{host}:"
            f"{server.server_address[1]} on {engine.device} "
            f"(POST /score, GET /healthz, GET /statsz)",
            flush=True,
        )
        if _block:
            try:
                server.serve_forever()
            except KeyboardInterrupt:
                server.shutdown()
        return server
