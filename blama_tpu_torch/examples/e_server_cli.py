"""Server-facade usage with a synchronization latch (reference:
examples/e_server_cli.py, after server/example/e-server-cli.cpp).

Usage: python -m blama_tpu_torch.examples.e_server_cli [model.gguf] [--device cpu]
"""

import sys
import threading

from blama_tpu_torch.examples.common import parse_args, tiny_fixture
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.server.server import CompleteRequestParams, Server


def main() -> None:
    args, device = parse_args(sys.argv[1:])
    path = args[0] if args else tiny_fixture()

    model = Model(path, ModelParams(device=device))
    server = Server(model)

    latch = threading.Event()
    result = {}

    def on_complete(resp):
        result["resp"] = resp
        latch.set()

    server.complete_text(
        CompleteRequestParams(prompt="hello world", max_tokens=20, seed=42, temperature=0.0),
        on_complete,
    )
    latch.wait()
    text = "".join(t.token_str for t in result["resp"])
    print(f"completion: {text!r}")
    print(f"tokens: {[t.token_id for t in result['resp']]}")
    server.close()


if __name__ == "__main__":
    main()
