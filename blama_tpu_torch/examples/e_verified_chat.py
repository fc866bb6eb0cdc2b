"""Interactive chat with per-turn verification (reference:
examples/e_verified_chat.py, after inference/example/e-verified-chat.cpp).

Usage: python -m blama_tpu_torch.examples.e_verified_chat [model.gguf] [--device cpu]

Two sessions run side by side: the chat session generates each assistant
turn with top-10 logit capture; the verifier session replays it and scores
agreement before the turn is shown as trusted.
"""

import sys

from blama_tpu_torch.examples.common import parse_args, tiny_fixture
from blama_tpu_torch.runtime.antiprompt import AntipromptManager
from blama_tpu_torch.runtime.chat import ChatFormat, ChatMsg
from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator

CHATML = (
    "{% for message in messages %}{{'<|im_start|>' + message['role'] + '\n' + "
    "message['content'] + '<|im_end|>' + '\n'}}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|im_start|>assistant\n' }}{% endif %}"
)


def main() -> None:
    args, device = parse_args(sys.argv[1:])
    path = args[0] if args else tiny_fixture(chat_template=CHATML)

    model = Model(path, ModelParams(device=device))
    chat_params = ChatFormat.get_chat_params(model)
    if not chat_params.chat_template:
        chat_params.chat_template = CHATML
    fmt = ChatFormat(chat_params)

    gen_instance = Instance(model, InstanceInitParams())
    ver_instance = Instance(model, InstanceInitParams())

    history: list[ChatMsg] = []
    anti = AntipromptManager()
    anti.add_antiprompt("<|im_end|>")

    print("verified chat — type a message ('exit' to quit)")
    for line in sys.stdin:
        user_text = line.strip()
        if user_text in ("exit", "quit", ""):
            break
        history.append(ChatMsg("user", user_text))
        prompt = fmt.format_chat(history, True)
        tokens = model.vocab.tokenize(prompt, True, True)

        session = gen_instance.start_session(SessionInitParams(seed=1, temperature=0.7))
        session.set_initial_prompt(tokens)
        preds = []
        reply = ""
        for p in session.complete_stream(CompleteParams(max_tokens=128)):
            piece = model.vocab.token_to_string(p.token)
            if anti.feed_generated_text(piece):
                break
            preds.append(p)
            reply += piece
            print(piece, end="", flush=True)
        gen_instance.stop_session()
        print()

        # verify the turn on the second instance
        verifier = ver_instance.start_session(SessionInitParams(seed=1, temperature=0.7))
        verifier.set_initial_prompt(tokens)
        replayed = verifier.fill_ctx(preds)
        ver_instance.stop_session()
        agg = MetricsAggregator()
        score = 0.0
        for o, r in zip(preds, replayed):
            score = agg.push_and_verify(LogitComparer.compare(o.logits, r.logits))
        print(f"  [verification score: {score:.4f} — "
              f"{'trusted' if score >= 0.95 else 'UNTRUSTED'}]")

        history.append(ChatMsg("assistant", reply))


if __name__ == "__main__":
    main()
