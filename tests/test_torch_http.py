"""HTTP round trips through the port's server on the CPU (`device="cpu"`,
ephemeral port): the four endpoints, 400/404/413, /metrics and the wire
format of tests/test_http_server.py, in solo mode and over the
continuous-batching scheduler (dense rows and the paged pool). One response
is held against the JAX package's server on the same request."""

import json
import threading
import urllib.error
import urllib.request

import pytest
import torch

from blama_tpu.runtime.instance import InstanceInitParams as JInstanceInitParams
from blama_tpu.runtime.model import Model as JModel
from blama_tpu.runtime.model import ModelParams as JModelParams
from blama_tpu.server.http import HttpServer as JHttpServer
from blama_tpu.server.server import Server as JServer
from blama_tpu_torch.runtime.instance import InstanceInitParams
from blama_tpu_torch.runtime.model import Model, ModelParams
from blama_tpu_torch.server import http as phttp
from blama_tpu_torch.server.http import HttpServer
from blama_tpu_torch.server.scheduler_server import SchedulerServer
from blama_tpu_torch.server.server import Server
from blama_tpu_torch.testing import write_tiny_llama

torch.set_num_threads(1)   # tiny shapes: threads only contend with the other test workers

CHATML = (
    "{% for message in messages %}{{'<|im_start|>' + message['role'] + '\n' + "
    "message['content'] + '<|im_end|>' + '\n'}}{% endfor %}"
    "{% if add_generation_prompt %}{{ '<|im_start|>assistant\n' }}{% endif %}"
)
TIMEOUT = 120


@pytest.fixture(scope="module")
def gguf_path(tmp_path_factory):
    p = str(tmp_path_factory.mktemp("http") / "tiny.gguf")
    write_tiny_llama(p, chat_template=CHATML)
    return p


@pytest.fixture(scope="module")
def model(gguf_path):
    m = Model(gguf_path, ModelParams(dtype="q4k_a8", attn="fused", device="cpu"))
    yield m
    m.close()


def _serve(api, srv_cls=HttpServer):
    srv = srv_cls(("127.0.0.1", 0), api, request_timeout=TIMEOUT)
    t = threading.Thread(target=srv.serve_forever, daemon=True)
    t.start()
    return srv, t, f"http://127.0.0.1:{srv.server_address[1]}"


def _stop(srv, t, api):
    srv.shutdown()
    t.join(timeout=30)
    srv.server_close()
    api.close()
    assert not t.is_alive()


@pytest.fixture(scope="module", params=["solo", "scheduler", "scheduler_paged", "solo_f32"])
def server(request, model):
    params = InstanceInitParams(ctx_size=128, flash_attn=True, kv_dtype="bfloat16")
    if request.param == "solo_f32":
        # the solo server as `main` builds it: the reference's default f32 KV
        api = Server(model, InstanceInitParams(ctx_size=128))
        assert api._instance.cache.k_store.dtype == torch.float32
    elif request.param == "solo":
        api = Server(model, params)
    else:
        api = SchedulerServer(model, params, max_batch=2, horizon=4,
                              paged=request.param == "scheduler_paged")
    srv, t, url = _serve(api)
    yield url
    _stop(srv, t, api)


def post(url, payload):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(), method="POST",
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=TIMEOUT) as r:
        assert r.headers["Content-Type"] == "text/json"
        assert r.headers["Access-Control-Allow-Origin"] == "*"
        return r.status, json.loads(r.read())


def _status(req):
    try:
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status
    except urllib.error.HTTPError as e:
        return e.code


def test_complete_roundtrip_and_verify(server):
    request = {"prompt": "hello world", "max_tokens": 6, "seed": 42, "temp": 0.0}
    status, out = post(server + "/complete", request)
    assert status == 200
    assert set(out) - {"finish_reason"} == {"text", "tokenData"}
    assert 1 <= len(out["tokenData"]) <= 6
    td = out["tokenData"][0]
    assert set(td) == {"str", "id", "logits"}
    assert len(td["logits"]) == 10
    assert set(td["logits"][0]) == {"id", "logit"}
    assert out["text"] == "".join(t["str"] for t in out["tokenData"])
    status, vr = post(server + "/verify_completion",
                      {"request": request, "response": {"tokenData": out["tokenData"]}})
    assert status == 200 and vr == {"result": 1.0}


def test_verify_detects_tampering(server):
    request = {"prompt": "the cat sat", "max_tokens": 5, "seed": 1, "temp": 0.0}
    _, out = post(server + "/complete", request)
    tampered = [dict(td) for td in out["tokenData"]]
    for td in tampered:
        td["logits"] = [{"id": l["id"], "logit": l["logit"] * 3.0 + 5.0} for l in td["logits"]]
    _, vr = post(server + "/verify_completion",
                 {"request": request, "response": {"tokenData": tampered}})
    assert vr["result"] < 0.95


def test_chat_completions_and_chat_verify(server):
    request = {"messages": [{"role": "system", "content": "you are helpful"},
                            {"role": "user", "content": "hello"}],
               "max_tokens": 4, "seed": 7, "temp": 0.0}
    status, out = post(server + "/chat/completions", request)
    assert status == 200 and len(out["tokenData"]) >= 1
    status, vr = post(server + "/chat/verify_completion",
                      {"request": request, "response": {"tokenData": out["tokenData"]}})
    assert status == 200 and vr["result"] == 1.0


def test_sampled_request_is_seeded(server):
    request = {"prompt": "hello", "max_tokens": 6, "seed": 5, "temp": 1.5, "top_p": 1.0}
    a = post(server + "/complete", request)[1]
    b = post(server + "/complete", request)[1]
    c = post(server + "/complete", dict(request, seed=6))[1]
    ids = lambda r: [t["id"] for t in r["tokenData"]]   # noqa: E731
    assert ids(a) == ids(b) and ids(a) != ids(c)


@pytest.mark.parametrize("path,body,method,code", [
    ("/nope", b"{}", "POST", 404),
    ("/complete", None, "GET", 400),
    ("/complete", b"not json", "POST", 400),
    ("/complete", b'{"max_tokens": 3}', "POST", 400),          # no prompt
    ("/verify_completion", b'{"request": {"prompt": "x"}}', "POST", 400),
])
def test_error_statuses(server, path, body, method, code):
    assert _status(urllib.request.Request(server + path, data=body, method=method)) == code


def test_oversized_payload_rejected(server):
    req = urllib.request.Request(
        server + "/complete", data=json.dumps({"prompt": "x" * 1000}).encode(), method="POST",
        headers={"Content-Type": "application/json", "Content-Length": str(64 << 20)})
    try:
        status = _status(req)
    except OSError:
        status = 413  # a connection reset after the 413 is acceptable too
    assert status == 413


def test_metrics_endpoint(server):
    post(server + "/complete", {"prompt": "hello", "max_tokens": 3, "temp": 0.0})
    with urllib.request.urlopen(server + "/metrics", timeout=30) as r:
        snap = json.loads(r.read())
    snap = snap.get("scheduler", snap) if snap["tokens_decoded"] == 0 else snap
    assert snap["tokens_decoded"] >= 1 and snap["tokens_prefilled"] >= 1
    assert "timers" in snap


def test_concurrent_requests_on_the_scheduler(model):
    """More concurrent requests than rows, over the paged pool: each answer
    equals the one the same request gets alone."""
    from concurrent.futures import ThreadPoolExecutor

    api = SchedulerServer(model, InstanceInitParams(ctx_size=128), max_batch=2,
                          paged=True, horizon=4)
    srv, t, url = _serve(api)
    try:
        reqs = [{"prompt": p, "max_tokens": 5, "temp": 0.0}
                for p in ("hello world the cat", "the cat sat on the", "president george bush",
                          "hello the cat", "the world sat")]
        alone = [post(url + "/complete", r)[1] for r in reqs]
        with ThreadPoolExecutor(len(reqs)) as ex:
            futs = [ex.submit(post, url + "/complete", r) for r in reqs]
            together = [f.result(timeout=TIMEOUT)[1] for f in futs]
        assert together == alone
        assert all(r["finish_reason"] == "length" for r in together)
    finally:
        _stop(srv, t, api)


def test_wire_format_equals_jax_server(gguf_path, model):
    """The same greedy request through both packages' solo servers: the same
    keys, the same token ids and strings, and each server's
    /verify_completion scores the other's response above the cross-backend
    threshold."""
    jm = JModel(gguf_path, JModelParams(dtype="q4k_a8", attn="fused"))
    japi = JServer(jm, JInstanceInitParams(ctx_size=128, flash_attn=True, kv_dtype="bfloat16"))
    papi = Server(model, InstanceInitParams(ctx_size=128, flash_attn=True,
                                            kv_dtype="bfloat16"))
    jsrv, jt, jurl = _serve(japi, JHttpServer)
    psrv, pt, purl = _serve(papi)
    try:
        request = {"prompt": "hello world the cat", "max_tokens": 6, "seed": 3, "temp": 0.0}
        ref = post(jurl + "/complete", request)[1]
        out = post(purl + "/complete", request)[1]
        assert set(out) == set(ref)
        assert [(t["id"], t["str"]) for t in out["tokenData"]] == \
            [(t["id"], t["str"]) for t in ref["tokenData"]]
        # each server verifies the other's response over its own endpoint
        for url, resp in ((jurl, out), (purl, ref)):
            vr = post(url + "/verify_completion",
                      {"request": request, "response": {"tokenData": resp["tokenData"]}})[1]
            assert vr["result"] >= 0.95, (url, vr)
    finally:
        _stop(psrv, pt, papi)
        _stop(jsrv, jt, japi)
        jm.close()


def test_env_config(monkeypatch, gguf_path):
    monkeypatch.setenv("BLAMA_PORT", "70000")
    with pytest.raises(ValueError):
        phttp.env_config()
    monkeypatch.setenv("BLAMA_PORT", "x1")
    with pytest.raises(ValueError):
        phttp.env_config()
    monkeypatch.setenv("BLAMA_PORT", "8080")
    monkeypatch.setenv("BLAMA_HOST", "127.0.0.1")
    monkeypatch.setenv("BLAMA_MODEL", gguf_path)
    assert phttp.env_config() == ("127.0.0.1", 8080, gguf_path)
    monkeypatch.setenv("BLAMA_MODEL", gguf_path + ".bin")
    with pytest.raises(ValueError):
        phttp.env_config()


def test_main_serves_solo_on_f32_kv(monkeypatch, gguf_path):
    """`python -m blama_tpu_torch.server.http` without BLAMA_SCHEDULER keeps
    the reference's solo Instance defaults: an f32 KV store."""
    seen = {}

    class Stop(Exception):
        pass

    def recording_server(model, params):
        api = Server(model, params)
        seen["kv"] = api._instance.cache.k_store.dtype
        api.close()
        model.close()
        raise Stop

    monkeypatch.setenv("BLAMA_MODEL", gguf_path)
    monkeypatch.setenv("BLAMA_DEVICE", "cpu")
    for var in ("BLAMA_SCHEDULER", "BLAMA_MULTIHOST", "BLAMA_PORT"):
        monkeypatch.delenv(var, raising=False)
    monkeypatch.setattr(phttp, "Server", recording_server)
    with pytest.raises(Stop):
        phttp.main()
    assert seen["kv"] == torch.float32


def test_main_refuses_multihost(monkeypatch, gguf_path):
    monkeypatch.setenv("BLAMA_MODEL", gguf_path)
    monkeypatch.setenv("BLAMA_MULTIHOST", "1")
    monkeypatch.delenv("BLAMA_PORT", raising=False)
    with pytest.raises(NotImplementedError, match="item 13"):
        phttp.main()
