"""Tiny Fire-style CLI dispatcher (a copy of `intrepppid_tpu/cli/parser.py`).

The reference exposes its CLI with Google Fire over a ``Pipeline`` object
(`intrepppid/__main__.py:22-33`): ``intrepppid <group> <command> --flag v``.
Fire is not a dependency here; this module provides the same surface by
introspecting function signatures with argparse underneath:

    intrepppid_tpu_torch serve start --weights_path ... --spm_path ...

Booleans accept ``--flag`` / ``--flag True|False``; None-default params
stay optional; type annotations drive parsing.
"""
from __future__ import annotations

import argparse
import inspect
import typing
from pathlib import Path
from typing import Any, Callable, Dict, Union


def _parse_bool(v: str) -> bool:
    if isinstance(v, bool):
        return v
    if v.lower() in ("1", "true", "yes", "y"):
        return True
    if v.lower() in ("0", "false", "no", "n"):
        return False
    raise argparse.ArgumentTypeError(f"expected a boolean, got {v!r}")


def _unwrap(annotation):
    origin = typing.get_origin(annotation)
    if origin is Union:
        args = [a for a in typing.get_args(annotation) if a is not type(None)]
        if len(args) == 1:
            return args[0]
        # e.g. Union[float, str] (lr): parse as str if float() fails
        return tuple(args)
    return annotation


def _converter(annotation) -> Callable[[str], Any]:
    ann = _unwrap(annotation)
    if isinstance(ann, tuple):
        def conv(v: str):
            for t in ann:
                try:
                    if t is bool:
                        return _parse_bool(v)
                    return t(v)
                except (ValueError, argparse.ArgumentTypeError):
                    continue
            return v
        return conv
    if ann is bool:
        return _parse_bool
    if ann in (Path, "Path"):
        return Path
    if ann in (int, float, str):
        return ann
    return str


def add_function_parser(subparsers, name: str, fn: Callable) -> None:
    doc = inspect.getdoc(fn) or ""
    parser = subparsers.add_parser(
        name, help=doc.splitlines()[0] if doc else None, description=doc,
        formatter_class=argparse.ArgumentDefaultsHelpFormatter,
    )
    sig = inspect.signature(fn)
    try:
        # resolve PEP 563 string annotations into real types
        hints = typing.get_type_hints(fn)
    except Exception:
        hints = {}
    for pname, param in sig.parameters.items():
        if pname == "self" or pname.startswith("_"):
            # underscore params are internal (e.g. Serve.start(_block=...)
            # used by tests) — not part of the CLI surface
            continue
        conv = _converter(hints.get(pname, param.annotation))
        required = param.default is inspect.Parameter.empty
        kwargs: Dict[str, Any] = {"type": conv, "required": required}
        if not required:
            kwargs["default"] = param.default
        if _unwrap(hints.get(pname, param.annotation)) is bool and not required:
            # allow bare --flag as well as --flag true/false
            kwargs["nargs"] = "?"
            kwargs["const"] = True
        parser.add_argument(f"--{pname}", **kwargs)
    parser.set_defaults(_fn=fn)


def _positionals_to_flags(rest, fn):
    """Fire-parity argv rewrite: the reference's CLI (Google Fire,
    `intrepppid/__main__.py:22-33`) accepts leading positional operands
    bound to the function's parameters in signature order — its docs use
    that style (``intrepppid train e2e_rnn_triplet DATASET.h5 spm.model 3
    100 80 --seed ...``, `docs/guide.rst`). Map each leading token that
    isn't a flag onto the next parameter, then hand the result (plus the
    untouched ``--flag`` tail) to argparse."""
    names = [
        p
        for p in inspect.signature(fn).parameters
        if p != "self" and not p.startswith("_")
    ]

    def is_flag(tok: str) -> bool:
        if not tok.startswith("-") or tok == "-":
            return False
        try:  # Fire binds negative numbers positionally (e.g. --seed -1)
            float(tok)
            return False
        except ValueError:
            return True

    out = []
    i = 0
    for name in names:
        if i >= len(rest) or is_flag(rest[i]):
            break
        out += [f"--{name}", rest[i]]
        i += 1
    return out + list(rest[i:])


def dispatch(groups: Dict[str, object], argv=None, prog: str = "intrepppid_tpu_torch"):
    """``groups`` maps group name -> object whose public methods are commands."""
    parser = argparse.ArgumentParser(prog=prog)
    group_sub = parser.add_subparsers(dest="group", required=True)
    commands: Dict[tuple, Callable] = {}
    for gname, gobj in groups.items():
        gparser = group_sub.add_parser(gname)
        cmd_sub = gparser.add_subparsers(dest="command", required=True)
        for cname, fn in inspect.getmembers(gobj, callable):
            if cname.startswith("_"):
                continue
            add_function_parser(cmd_sub, cname, fn)
            commands[(gname, cname)] = fn
    if argv is None:
        import sys

        argv = sys.argv[1:]
    argv = list(argv)
    if len(argv) >= 2 and (argv[0], argv[1]) in commands:
        argv = argv[:2] + _positionals_to_flags(
            argv[2:], commands[(argv[0], argv[1])]
        )
    args = parser.parse_args(argv)
    fn = args._fn
    kwargs = {
        k: v for k, v in vars(args).items() if k not in ("group", "command", "_fn")
    }
    return fn(**kwargs)
