"""Run-name generation (`intrepppid_tpu/utils/run_name.py`, a copy;
`intrepppid/cli/train.py:82-86` in the reference).

``YY.DDD-HH.MM-<word>-<word>``: strftime("%y.%j-%H.%M") plus a two-word
passphrase. The reference uses passlib's EFF wordlist; we carry a compact
built-in wordlist to avoid the dependency.
"""
from __future__ import annotations

import random
from datetime import datetime

_WORDS = (
    "acorn alpine amber apricot aurora basil bamboo beacon birch breeze "
    "canyon cedar cipher citrus cobalt comet coral cosmos crystal cypress "
    "dahlia delta drift dune ember falcon fern flint fjord gale garnet "
    "ginger glacier grove harbor hazel heron indigo iris jasper juniper "
    "kelp lagoon larch lotus lumen maple meadow mesa mistral nectar nimbus "
    "oasis obsidian onyx opal orchid osprey pebble pine plume prism quartz "
    "quill raven reef ridge river saffron sage sequoia sierra sparrow "
    "spruce summit sycamore tundra umber vale vortex walnut willow wren "
    "yarrow zephyr zenith"
).split()


def generate_passphrase(length: int = 2, sep: str = "-", rng=None) -> str:
    rng = rng or random
    return sep.join(rng.choice(_WORDS) for _ in range(length))


def generate_run_name(rng=None) -> str:
    dt = datetime.now().strftime("%y.%j-%H.%M")
    return f"{dt}-{generate_passphrase(2, '-', rng)}"
