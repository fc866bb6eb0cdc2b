"""Chat formatting: named built-in templates + Jinja templates.

Mirror of the reference ChatFormat (reference llama/
ChatFormat.{hpp,cpp}) with its two implementations:

  * NamedTemplateImpl ≙ LlamaImpl → llama_chat_apply_template: detects a
    template family from the template string (or accepts the short name
    directly) and applies hand-written formatting. Behavior is pinned by the
    expected outputs in the reference test suite (t-ChatFormat.cpp:42-242).
  * JinjaImpl → minja: full Jinja evaluation (jinja2 here), with bos/eos
    passed in, `assistant_role` extra context, and the reference's bos/eos
    dedup-stripping quirk preserved (ChatFormat.cpp:170-180).

Incremental formatting (formatMsg) is diff-of-formats, exactly as the
reference computes it (ChatFormat.cpp:47-66,128-140).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class ChatMsg:
    role: str
    text: str


@dataclass
class ChatParams:
    """Reference: ChatFormat::Params (ChatFormat.hpp:21-26)."""

    chat_template: str = ""
    bos_token: str = ""
    eos_token: str = ""
    role_assistant: str = "assistant"


# ---------------------------------------------------------------------------
# named template engine
# ---------------------------------------------------------------------------

_KNOWN_IDS = {
    "chatml", "llama2", "llama2-sys", "llama2-sys-bos", "llama2-sys-strip",
    "mistral-v1", "mistral-v3", "mistral-v3-tekken", "mistral-v7", "llama3",
    "monarch", "gemma", "orion", "openchat", "vicuna", "vicuna-orca",
    "deepseek", "deepseek2", "deepseek3", "command-r", "phi3", "phi4",
    "chatglm3", "chatglm4", "glmedge", "minicpm", "granite", "gigachat",
    "megrez", "zephyr", "falcon3", "exaone3",
}


def detect_template(tmpl: str) -> str:
    """Map a Jinja template string (or short name) to a template family id.

    Same substring-sniffing approach as llama.cpp's template detection; the
    families and their formatting are pinned by t-ChatFormat.cpp.
    """
    if tmpl in _KNOWN_IDS:
        return tmpl
    c = tmpl.__contains__
    if c("<|im_sep|>"):
        return "phi4"
    if c("<|im_start|>"):
        return "chatml"
    if c("[SYSTEM_PROMPT]"):
        return "mistral-v7"
    if c("' [INST] ' + system_message"):
        return "mistral-v1"
    if c("[AVAILABLE_TOOLS]"):
        return "mistral-v3" if c('"[INST] "') else "mistral-v3-tekken"
    if c("[INST]"):
        if c("content.strip()"):
            return "llama2-sys-strip"
        if c("<<SYS>>"):
            return "llama2-sys-bos" if c("bos_token + '[INST]") else "llama2-sys"
        return "llama2"
    if c("<|start_header_id|>") and c("<|end_header_id|>"):
        return "llama3"
    if c("<start_of_turn>"):
        return "gemma"
    if c("'Human: '") or (c("Human: ") and c("Assistant: ")):
        return "orion"
    if c("GPT4 Correct "):
        return "openchat"
    if c("USER: ") and c("ASSISTANT: "):
        return "vicuna-orca" if c("SYSTEM: ") else "vicuna"
    if c("### Instruction:") and c("<|EOT|>"):
        return "deepseek"
    if c("<|START_OF_TURN_TOKEN|>"):
        return "command-r"
    if c("[gMASK]sop"):
        return "chatglm3"
    if c("[gMASK]<sop>"):
        return "chatglm4"
    if c("<用户>"):
        return "minicpm"
    if c("'User: ' + message['content'] + '\\n\\n'") or (c("User: ") and c("Assistant: ") and c("eos_token")):
        return "deepseek2"
    if c("<|start_of_role|>"):
        return "granite"
    if c("additional_special_tokens"):
        return "gigachat"
    if c("<|role_start|>"):
        return "megrez"
    if c("<|endoftext|>") and c("<|user|>"):
        return "zephyr"
    if c("<|user|>") and c("<|end|>"):
        return "phi3"
    if c("<|user|>") and c("<|assistant|>"):
        return "glmedge"
    if c("bos_token + message['role']"):
        return "monarch"
    raise ValueError(f"Unsupported chat template: {tmpl[:60]!r}")


def _apply_named(tid: str, chat: list[ChatMsg], add_ass: bool) -> str:
    """Apply a named template family. Each branch's output format is pinned by
    the reference's expected strings (t-ChatFormat.cpp)."""
    out: list[str] = []
    w = out.append

    if tid == "chatml":
        for m in chat:
            w(f"<|im_start|>{m.role}\n{m.text}<|im_end|>\n")
        if add_ass:
            w("<|im_start|>assistant\n")

    elif tid in ("llama2", "llama2-sys", "llama2-sys-bos", "llama2-sys-strip"):
        support_sys = tid != "llama2"
        bos_rounds = tid == "llama2-sys-bos"
        strip = tid == "llama2-sys-strip"
        sys_msg = ""
        is_first_round = True
        for m in chat:
            content = m.text.strip() if strip else m.text
            if m.role == "system":
                if support_sys:
                    sys_msg = f"<<SYS>>\n{content}\n<</SYS>>\n\n"
                else:
                    sys_msg = content + "\n"
            elif m.role == "user":
                prefix = "" if is_first_round or not bos_rounds else "<s>"
                w(f"{prefix}[INST] {sys_msg}{content} [/INST]")
                sys_msg = ""
                is_first_round = False
            else:
                w(f"{content}</s>")

    elif tid == "mistral-v1":
        sys_msg = ""
        for m in chat:
            if m.role == "system":
                sys_msg = m.text + "\n\n"
            elif m.role == "user":
                w(f" [INST] {sys_msg}{m.text} [/INST]")
                sys_msg = ""
            else:
                w(f" {m.text}</s>")

    elif tid in ("mistral-v3", "mistral-v3-tekken"):
        tekken = tid.endswith("tekken")
        inst = "[INST]" if tekken else "[INST] "
        sys_msg = ""
        for m in chat:
            if m.role == "system":
                sys_msg = m.text + "\n\n"
            elif m.role == "user":
                w(f"{inst}{sys_msg}{m.text}[/INST]")
                sys_msg = ""
            else:
                w(m.text + "</s>" if tekken else f" {m.text.strip()}</s>")

    elif tid == "mistral-v7":
        for m in chat:
            if m.role == "system":
                w(f"[SYSTEM_PROMPT] {m.text}[/SYSTEM_PROMPT]")
            elif m.role == "user":
                w(f"[INST] {m.text}[/INST]")
            else:
                w(f" {m.text}</s>")

    elif tid == "llama3":
        for m in chat:
            w(f"<|start_header_id|>{m.role}<|end_header_id|>\n\n{m.text.strip()}<|eot_id|>")
        if add_ass:
            w("<|start_header_id|>assistant<|end_header_id|>\n\n")

    elif tid == "monarch":
        for i, m in enumerate(chat):
            bos = "" if i == 0 else "<s>"
            w(f"{bos}{m.role}\n{m.text}</s>\n")
        if add_ass:
            w("<s>assistant\n")

    elif tid == "gemma":
        sys_msg = ""
        for m in chat:
            if m.role == "system":
                sys_msg = m.text + "\n\n"
                continue
            role = "model" if m.role == "assistant" else m.role
            w(f"<start_of_turn>{role}\n{sys_msg}{m.text.strip()}<end_of_turn>\n")
            sys_msg = ""
        if add_ass:
            w("<start_of_turn>model\n")

    elif tid == "orion":
        sys_msg = ""
        for m in chat:
            if m.role == "system":
                sys_msg = m.text + "\n\n"
            elif m.role == "user":
                w(f"Human: {sys_msg}{m.text}\n\nAssistant: </s>")
                sys_msg = ""
            else:
                w(f"{m.text}</s>")

    elif tid == "openchat":
        for m in chat:
            if m.role == "system":
                w(f"{m.text}<|end_of_turn|>")
            else:
                w(f"GPT4 Correct {m.role.title()}: {m.text}<|end_of_turn|>")
        if add_ass:
            w("GPT4 Correct Assistant:")

    elif tid in ("vicuna", "vicuna-orca"):
        for m in chat:
            if m.role == "system":
                w(f"SYSTEM: {m.text}\n" if tid == "vicuna-orca" else f"{m.text}\n\n")
            elif m.role == "user":
                w(f"USER: {m.text}\n")
            else:
                w(f"ASSISTANT: {m.text}</s>\n")
        if add_ass:
            w("ASSISTANT:")

    elif tid == "deepseek":
        for m in chat:
            if m.role == "system":
                w(m.text)
            elif m.role == "user":
                w(f"### Instruction:\n{m.text}\n")
            else:
                w(f"### Response:\n{m.text}\n<|EOT|>\n")
        if add_ass:
            w("### Response:\n")

    elif tid == "deepseek2":
        for m in chat:
            if m.role == "system":
                w(m.text + "\n\n")
            elif m.role == "user":
                w(f"User: {m.text}\n\n")
            else:
                w(f"Assistant: {m.text}<｜end▁of▁sentence｜>")
        if add_ass:
            w("Assistant:")

    elif tid == "deepseek3":
        for m in chat:
            if m.role == "system":
                w(m.text + "\n\n")
            elif m.role == "user":
                w(f"<｜User｜>{m.text}")
            else:
                w(f"<｜Assistant｜>{m.text}<｜end▁of▁sentence｜>")
        if add_ass:
            w("<｜Assistant｜>")

    elif tid == "command-r":
        for m in chat:
            token = {
                "system": "<|SYSTEM_TOKEN|>",
                "user": "<|USER_TOKEN|>",
            }.get(m.role, "<|CHATBOT_TOKEN|>")
            w(f"<|START_OF_TURN_TOKEN|>{token}{m.text.strip()}<|END_OF_TURN_TOKEN|>")
        if add_ass:
            w("<|START_OF_TURN_TOKEN|><|CHATBOT_TOKEN|>")

    elif tid == "phi3":
        for m in chat:
            w(f"<|{m.role}|>\n{m.text}<|end|>\n")
        if add_ass:
            w("<|assistant|>\n")

    elif tid == "phi4":
        for m in chat:
            w(f"<|im_start|>{m.role}<|im_sep|>{m.text}<|im_end|>")
        if add_ass:
            w("<|im_start|>assistant<|im_sep|>")

    elif tid == "chatglm3":
        w("[gMASK]sop")
        for m in chat:
            w(f"<|{m.role}|>\n {m.text}")
        if add_ass:
            w("<|assistant|>")

    elif tid == "chatglm4":
        w("[gMASK]<sop>")
        for m in chat:
            w(f"<|{m.role}|>\n{m.text}")
        if add_ass:
            w("<|assistant|>")

    elif tid == "glmedge":
        for m in chat:
            w(f"<|{m.role}|>\n{m.text}")
        if add_ass:
            w("<|assistant|>")

    elif tid == "minicpm":
        for m in chat:
            if m.role == "user":
                w(f"<用户>{m.text.strip()}<AI>")
            else:
                w(m.text.strip())

    elif tid == "granite":
        for m in chat:
            w(f"<|start_of_role|>{m.role}<|end_of_role|>{m.text}<|end_of_text|>\n")
        if add_ass:
            w("<|start_of_role|>assistant<|end_of_role|>\n")

    elif tid == "gigachat":
        first = True
        for m in chat:
            if m.role == "system":
                w(f"<s>{m.text}<|message_sep|>")
                first = False
                continue
            if first:
                w("<s>")
                first = False
            if m.role == "user":
                w(f"user<|role_sep|>{m.text}<|message_sep|>")
                w("available functions<|role_sep|>[]<|message_sep|>")
            else:
                w(f"assistant<|role_sep|>{m.text}<|message_sep|>")
        if add_ass:
            w("assistant<|role_sep|>")

    elif tid == "megrez":
        for m in chat:
            w(f"<|role_start|>{m.role}<|role_end|>{m.text}<|turn_end|>")
        if add_ass:
            w("<|role_start|>assistant<|role_end|>")

    elif tid == "zephyr":
        for m in chat:
            w(f"<|{m.role}|>\n{m.text}<|endoftext|>\n")
        if add_ass:
            w("<|assistant|>\n")

    elif tid == "falcon3":
        for m in chat:
            w(f"<|{m.role}|>\n{m.text}\n")
        if add_ass:
            w("<|assistant|>\n")

    elif tid == "exaone3":
        for m in chat:
            if m.role == "system":
                w(f"[|system|]{m.text.strip()}[|endofturn|]\n")
            elif m.role == "user":
                w(f"[|user|]{m.text.strip()}\n")
            else:
                w(f"[|assistant|]{m.text.strip()}[|endofturn|]\n")
        if add_ass:
            w("[|assistant|]")

    else:
        raise ValueError(f"Unsupported template id {tid!r}")

    return "".join(out)


class NamedTemplateImpl:
    """≙ reference LlamaImpl (ChatFormat.cpp:36-105)."""

    def __init__(self, template_str: str):
        self.template_str = template_str
        self.tid = detect_template(template_str)

    def format_chat(self, chat: list[ChatMsg], add_assistant_prompt: bool) -> str:
        if not chat:
            return ""
        return _apply_named(self.tid, chat, add_assistant_prompt)

    def format_msg(self, msg: ChatMsg, history: list[ChatMsg], add_assistant_prompt: bool) -> str:
        if not history:
            return self.format_chat([msg], add_assistant_prompt)
        fmt_history = _apply_named(self.tid, history, False)
        fmt_new = _apply_named(self.tid, list(history) + [msg], add_assistant_prompt)
        ret = ""
        # preserve a trailing newline of the history (ChatFormat.cpp:59-62)
        if add_assistant_prompt and fmt_history.endswith("\n"):
            ret = "\n"
        return ret + fmt_new[len(fmt_history):]


class JinjaImpl:
    """≙ reference JinjaImpl (ChatFormat.cpp:107-186), jinja2-backed."""

    def __init__(self, params: ChatParams):
        import jinja2

        self.params = params
        env = jinja2.Environment(
            trim_blocks=True, lstrip_blocks=True, keep_trailing_newline=False,
            undefined=jinja2.ChainableUndefined,
        )

        def raise_exception(message):
            raise RuntimeError(f"Template error: {message}")

        def tojson(x, indent=None):
            import json

            return json.dumps(x, indent=indent, ensure_ascii=False)

        def strftime_now(fmt):
            import datetime

            return datetime.datetime.now().strftime(fmt)

        env.globals["raise_exception"] = raise_exception
        env.globals["strftime_now"] = strftime_now
        env.filters["tojson"] = tojson
        try:
            self._tmpl = env.from_string(params.chat_template)
        except Exception as e:
            raise RuntimeError(f"Unsupported jinja template. Error: {e}") from None

    def _apply(self, messages: list[dict], add_assistant_prompt: bool) -> str:
        result = self._tmpl.render(
            messages=messages,
            add_generation_prompt=add_assistant_prompt,
            bos_token=self.params.bos_token,
            eos_token=self.params.eos_token,
            assistant_role=self.params.role_assistant,
        )
        # bos/eos dedup-stripping, preserved verbatim from the reference
        # (ChatFormat.cpp:170-180) including its quirk: eos is trimmed from
        # the END but only when the result STARTS with it.
        bos, eos = self.params.bos_token, self.params.eos_token
        if bos and result.startswith(bos):
            result = result[len(bos):]
        if eos and result.startswith(eos):
            result = result[: len(result) - len(eos)]
        return result

    def format_chat(self, chat: list[ChatMsg], add_assistant_prompt: bool) -> str:
        if not chat:
            return ""
        msgs = [{"role": m.role, "content": m.text} for m in chat]
        return self._apply(msgs, add_assistant_prompt)

    def format_msg(self, msg: ChatMsg, history: list[ChatMsg], add_assistant_prompt: bool) -> str:
        if not history:
            return self.format_chat([msg], add_assistant_prompt)
        hist = [{"role": m.role, "content": m.text} for m in history]
        fmt_history = self._apply(hist, add_assistant_prompt)
        fmt_new = self._apply(hist + [{"role": msg.role, "content": msg.text}], add_assistant_prompt)
        return fmt_new[len(fmt_history):]


class ChatFormat:
    """Facade (ChatFormat.hpp:19-48): construct from a template string (named
    engine) or from ChatParams (Jinja engine)."""

    def __init__(self, template: str | ChatParams):
        if isinstance(template, ChatParams):
            self.template_str = template.chat_template
            self._impl = JinjaImpl(template)
        else:
            self.template_str = template
            self._impl = NamedTemplateImpl(template)

    @property
    def tpl(self) -> str:
        return self.template_str

    def format_chat(self, chat: list[ChatMsg], add_assistant_prompt: bool) -> str:
        return self._impl.format_chat(chat, add_assistant_prompt)

    def format_msg(self, msg: ChatMsg, history: list[ChatMsg], add_assistant_prompt: bool) -> str:
        return self._impl.format_msg(msg, history, add_assistant_prompt)

    @staticmethod
    def get_chat_params(model) -> ChatParams:
        """Pull template + BOS/EOS strings from the model
        (ChatFormat.cpp:209-230)."""
        p = ChatParams()
        p.chat_template = model.config.chat_template

        def token_str(token_id, jinja_var):
            if token_id is None or token_id < 0:
                return ""
            return model.vocab.token_to_string(token_id, special=True)

        p.bos_token = token_str(model.vocab.bos(), "bos_token")
        p.eos_token = token_str(model.vocab.eos(), "eos_token")
        return p
