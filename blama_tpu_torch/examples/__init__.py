"""The reference's example programs (examples/*.py) on the port.

Run each as a module from the repository root, on the card, or on the CPU
with `--device cpu` (or BLAMA_DEVICE=cpu):

    python -m blama_tpu_torch.examples.e_basic [model.gguf] [prompt] [--device cpu]
    python -m blama_tpu_torch.examples.e_verify [model.gguf] [prompt] [--device cpu]
    python -m blama_tpu_torch.examples.e_server_cli [model.gguf] [--device cpu]
    python -m blama_tpu_torch.examples.e_verified_chat [model.gguf] [--device cpu]

Without a model each writes the tiny synthetic fixture to a temporary file.
Each builds its Model as the reference's does, with ModelParams' defaults
(float32 weights, attn="xla") on the chosen device.
"""
