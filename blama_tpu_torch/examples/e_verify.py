"""Generate-then-verify round trip (reference: examples/e_verify.py, after
inference/example/e-verify.cpp).

Usage: python -m blama_tpu_torch.examples.e_verify [model.gguf] [prompt] [--device cpu]

The prover generates with top-10 logit capture; a fresh verifier session
replays the claimed tokens (teacher-forced), recomputes the logits restricted
to the claimed token set, and scores agreement. Same-backend the score is 1.0
(bit-exact); the reference's cross-backend acceptance threshold is >= 0.95
(t-LogitComparer.cpp:78).
"""

import sys

from blama_tpu_torch.examples.common import parse_args, tiny_fixture
from blama_tpu_torch.runtime.instance import Instance, InstanceInitParams
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.runtime.session import CompleteParams, SessionInitParams
from blama_tpu_torch.runtime.verify import LogitComparer, MetricsAggregator


def main() -> None:
    args, device = parse_args(sys.argv[1:])
    path = args[0] if args else tiny_fixture()
    prompt = args[1] if len(args) > 1 else "hello world"

    model = Model(path, ModelParams(device=device))
    instance = Instance(model, InstanceInitParams())

    # -- prover
    session = instance.start_session(SessionInitParams(seed=7, temperature=0.0))
    session.set_initial_prompt(model.vocab.tokenize(prompt, True, True))
    predictions = session.complete(CompleteParams(max_tokens=20))
    instance.stop_session()
    text = model.vocab.detokenize([p.token for p in predictions])
    print(f"prover generated: {text!r}")

    # -- verifier (fresh session, replays the claim)
    verifier = instance.start_session(SessionInitParams(seed=7, temperature=0.0))
    verifier.set_initial_prompt(model.vocab.tokenize(prompt, True, True))
    replayed = verifier.fill_ctx(predictions)
    instance.stop_session()

    agg = MetricsAggregator()
    score = 0.0
    sims = []
    for orig, rep in zip(predictions, replayed):
        m = LogitComparer.compare(orig.logits, rep.logits)
        score = agg.push_and_verify(m)
        sims.append(LogitComparer.logit_similarity(orig.logits, rep.logits))

    print(f"aggregate verification score: {score:.6f}")
    print(f"mean per-token similarity:    {sum(sims)/len(sims):.6f}")
    print("verdict:", "ACCEPT" if score >= 0.95 else "REJECT")


if __name__ == "__main__":
    main()
