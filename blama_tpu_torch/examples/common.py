"""What the examples share: their command line and the tiny fixture."""

from __future__ import annotations

import os
import tempfile


def parse_args(argv: list[str]) -> tuple[list[str], str]:
    """The positional arguments and the device: `--device NAME`, else
    BLAMA_DEVICE, else "cuda"."""
    args, device = [], os.environ.get("BLAMA_DEVICE", "cuda")
    it = iter(argv)
    for a in it:
        if a == "--device":
            device = next(it)
        elif a.startswith("--device="):
            device = a.split("=", 1)[1]
        else:
            args.append(a)
    return args, device


def tiny_fixture(chat_template: str = "") -> str:
    """A tiny synthetic llama GGUF in a new temporary file."""
    from ..testing import write_tiny_llama

    fd, path = tempfile.mkstemp(suffix=".gguf")
    os.close(fd)
    write_tiny_llama(path, chat_template=chat_template)
    return path
