"""Basic streaming generation (reference: examples/e_basic.py, after
inference/example/e-basic.cpp).

Usage: python -m blama_tpu_torch.examples.e_basic [model.gguf] [prompt] [--device cpu]
Without a model argument, a tiny synthetic fixture is generated.
"""

import sys

from blama_tpu_torch import init_library
from blama_tpu_torch.examples.common import parse_args, tiny_fixture
from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams


def progress_bar(p: float) -> None:
    print(f"\rloading: {p * 100:5.1f}%", end="", flush=True)


def main() -> None:
    init_library()
    args, device = parse_args(sys.argv[1:])
    if args:
        path = args[0]
    else:
        path = tiny_fixture()
        print(f"(no model given; using tiny synthetic fixture {path})")
    prompt = args[1] if len(args) > 1 else "The president of the United States"

    model = Model(path, ModelParams(device=device), progress_cb=progress_bar)
    print()
    instance = Instance(model, InstanceInitParams())
    instance.warmup()

    session = instance.start_session(SessionInitParams(seed=42))
    session.set_initial_prompt(model.vocab.tokenize(prompt, True, True))

    print(prompt, end="", flush=True)
    for pred in session.complete_stream(CompleteParams(max_tokens=100)):
        print(model.vocab.token_to_string(pred.token), end="", flush=True)
    print()
    instance.stop_session()


if __name__ == "__main__":
    main()
