"""The port's examples (``examples/pt_*.py``) on the CPU.

Each runs its ``main`` with ``--device cpu`` and prints the lines the
JAX example it mirrors prints (same order, same formats; the numbers
are the port's own, from its seeded weights). Where the JAX example is
greedy — the prefix-cache demo, the long-context stream, the chaos
demo's oracle and replay — the port's example run on JAX's float32
smoke weights (bridged) gives JAX's greedy stream.
"""
import dataclasses
import importlib.util
import os
import re

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke_config
from repro.models.model import decode_step as jax_decode_step
from repro.models.model import init_params as jax_init_params
from repro.models.prefill import prefill as jax_prefill
from repro_torch import bridge

EXAMPLES = os.path.join(os.path.dirname(__file__), os.pardir, "examples")


def _example(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(EXAMPLES, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _in_order(out: str, patterns):
    """Each regex matches a line of ``out``, in order."""
    lines = out.splitlines()
    i = 0
    for pat in patterns:
        while i < len(lines) and not re.search(pat, lines[i]):
            i += 1
        assert i < len(lines), f"no line matching {pat!r} in order:\n{out}"
        i += 1


def _bridged(arch):
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    jp = jax_init_params(jax.random.PRNGKey(0), cfg)
    return cfg, jp, bridge.from_numpy_tree(jax.tree.map(np.asarray, jp),
                                           device="cpu")


def _jax_greedy(jp, cfg, prompt, n_new):
    """JAX's dense greedy oracle (prefill + jitted decode_step)."""
    step = jax.jit(jax_decode_step, static_argnums=1)
    logits, state = jax_prefill(jp, cfg, jnp.asarray([prompt], jnp.int32),
                                max_len=len(prompt) + n_new + 2)
    out = [int(jnp.argmax(logits[0]))]
    for _ in range(n_new - 1):
        lg, state = step(jp, cfg, state, jnp.asarray([out[-1]], jnp.int32))
        out.append(int(jnp.argmax(lg[0])))
    return out


def test_quickstart(capsys):
    ex = _example("pt_quickstart")
    res = ex.main(["--device", "cpu"])
    _in_order(capsys.readouterr().out, [
        r"^model: qwen3-0\.6b-smoke \([\d.]+M params, family=dense\)$",
        r"^req 0 streaming:( \d+){12} $",
        *[rf"^req {i}: finished, 12 tokens, ttft=[\d.]+ms "
          r"tbt_mean=[\d.]+ms$" for i in range(3)],
        r"^prefix cache: cold ttft=[\d.]+ms, warm ttft=[\d.]+ms, "
        r"hit_tokens=[\d.]+, cached_blocks=[\d.]+$"])
    assert res["cold"] == res["warm"]
    cfg, jp, tp = _bridged("qwen3-0.6b")
    res = ex.prefix_caching_demo(tp, cfg, "cpu")
    assert res["cold"] == res["warm"] == \
        _jax_greedy(jp, cfg, res["prompt"], 8)


def test_long_context(capsys):
    ex = _example("pt_long_context")
    out, ref = ex.main(["--device", "cpu"])
    assert out == ref
    _in_order(capsys.readouterr().out, [
        r"^prompt len 100; per-instance local window 24 -> needs cluster "
        r"pooling$",
        r"^spanned output: \[(\d+, ){11}\d+\]$",
        r"^reference:      \[(\d+, ){11}\d+\]$",
        r"^exact match: True$",
        r"^blocks held per instance at finish: \{0: 0, 1: 0, 2: 0, 3: 0, "
        r"4: 0, 5: 0\}$",
        r"^long-context DistAttention == single-cache reference\.$"])
    cfg, jp, tp = _bridged("mistral-nemo-12b")
    out, _ = ex.serve_long(tp, cfg, "cpu")
    prompt = [int(t) for t in np.random.default_rng(1).integers(
        0, cfg.vocab_size, size=100)]
    assert out == _jax_greedy(jp, cfg, prompt, 12)


def test_serve_cluster_and_chaos(capsys):
    ex = _example("pt_serve_cluster")
    ex.main(["--device", "cpu"])
    _in_order(capsys.readouterr().out, [
        r"^step 005: \+\d+ tok  \(inst -> batch, mem_util\) \{",
        r"^>>> cancelling req 1 mid-flight$",
        r"^>>> elastic scale-out: adding instance$",
        r"^KV moved: [\d.]+ KiB; query/merge traffic: [\d.]+ KiB$",
        r"^  \[finished \] req 0 out=10 ttft=\d+ms$",
        r"^  \[cancelled\] req 1 ",
        r"^all surviving requests served; cancellation released its KV\.$",
        r"^--- overload survival demo \(preemptive pause/resume\) ---$",
        r"^  victim req 0 PAUSED \(preempt tier holds \d+ KV frames\)$",
        r"^  urgent burst served on time: \['finished', 'finished'\]$",
        r"^  victim resumed and finished: 48 tokens, preemptions=1 "
        r"resumes=1 est arrival rate=[\d.]+/s$",
        r"^overload survived: victim paused, spilled, resumed intact\.$"])
    cfg, jp, tp = _bridged("olmo-1b")
    prompt, ref, out = ex.chaos_demo(tp, cfg, "cpu")
    assert out == ref == _jax_greedy(jp, cfg, prompt, 12)
    _in_order(capsys.readouterr().out, [
        r"^--- chaos demo \(crash detection \+ token-replay recovery\) ---$",
        r"^>>> killing instance \d+ \(serves req 0, 4 tokens emitted\)$",
        r"^  dead instances: 1  recoveries: 1  replayed tokens: \d+$",
        r"^  oracle: \[", r"^  replay: \[",
        r"^crash survived: rank quarantined, request replayed, stream "
        r"byte-identical\.$"])


def test_train_small(tmp_path, capsys):
    ex = _example("pt_train_small")
    losses = ex.main(["--device", "cpu", "--steps", "2", "--ckpt-dir",
                      str(tmp_path)])
    assert len(losses) == 1 and np.isfinite(losses[0])
    _in_order(capsys.readouterr().out, [
        r"^qwen3-100m: [\d.]+M params$",
        r"^step    0 loss [\d.]+ \(\d+s\)$",
        r"^>>> checkpoint @ step 0; simulating restart$",
        r"^final loss [\d.]+ \(random-chance 9\.01\)$"])
    assert os.listdir(tmp_path)

