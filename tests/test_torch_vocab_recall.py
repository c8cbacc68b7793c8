"""The port's vocabulary recall bench (tools/torch_bench_vocab_recall.py)
against the JAX package's (tools/bench_vocab_recall.py), on the CPU.

Both run the same 60-frame revisit sequence through their own renderer,
host extractor (the JAX side on its own native build, jax_native_library),
shipped 32k-word tree and keyframe database: the recall, the number of
queries and the vocabulary's size must be equal (the host kernels and the
tree's quantization are bit-equal between the packages,
tests/test_torch_host_kernels.py, tests/test_torch_bow.py)."""

import contextlib
import io
import json

import pytest

from tests.test_torch_host_kernels import jax_native_library
from tests.test_torch_system import one_torch_thread
from tools import bench_vocab_recall, torch_bench_vocab_recall

N_FRAMES = 60


@pytest.fixture(scope="module")
def readings(tmp_path_factory):
    """(the port's returned result, its printed lines, the JAX tool's
    printed lines), each package's bench run once."""
    port_out, jax_out = io.StringIO(), io.StringIO()
    with one_torch_thread():
        with contextlib.redirect_stdout(port_out):
            port = torch_bench_vocab_recall.main(n_frames=N_FRAMES, device="cpu")
        with jax_native_library(tmp_path_factory.mktemp("jax_native")), \
                contextlib.redirect_stdout(jax_out):
            bench_vocab_recall.main(n_frames=N_FRAMES)
    return port, port_out.getvalue().strip().splitlines(), jax_out.getvalue().strip().splitlines()


def test_recall_equals_the_jax_tools(readings):
    port, _, jax_lines = readings
    jax = json.loads(jax_lines[-1])
    assert port["bench"] == jax["bench"] == "vocab_recall"
    assert port["k"] == jax["k"] == 5 and port["n_frames"] == jax["n_frames"] == N_FRAMES
    for key in ("recall_at_k", "queries", "n_words"):
        assert port["default"][key] == jax["default"][key], key
    assert port["default"]["n_words"] == 32768 and port["default"]["queries"] == 20


def test_the_port_prints_the_jax_tools_lines(readings):
    """The JSON line the port prints last is what it returns, with the JAX
    tool's keys; the line before it names the vocabulary, as the JAX
    tool's does."""
    port, port_lines, jax_lines = readings
    assert json.loads(port_lines[-1]) == port
    jax = json.loads(jax_lines[-1])
    assert set(port) == set(jax) and set(port["default"]) == set(jax["default"])
    assert port_lines[-2].startswith("default: {") and jax_lines[-2].startswith("default: {")
