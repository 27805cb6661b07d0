"""The port's new CLI commands against the JAX package's on the CPU:
`rewards emissions` and `rewards mint` print the reference's JSON;
`prover audit-degrees --device cpu` prints the reference's line per AIR
(built from the JAX golden `tests/data/torch_degree_golden.npz` in tier 1,
and from the JAX CLI itself in the slow case); `prover generate-config`
refuses to size a config without a card; `prover bootstrap-verifier`
(slow: minutes of host work) writes files byte for byte equal to
`contracts/Groth16Verifier.sol` and `contracts/bootstrap.json`."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from boundless_tpu import cli as jcli
from boundless_tpu_torch import cli

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = os.path.join(ROOT, "tests", "data", "torch_degree_golden.npz")


def run(main, argv) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        main(argv)
    return buf.getvalue()


@pytest.mark.parametrize("epoch,count", [(0, 1), (0, 5), (17, 3),
                                         (1000, 2)])
def test_rewards_emissions_equal_jax(epoch, count):
    argv = ["rewards", "emissions", "--epoch", str(epoch), "--count",
            str(count)]
    out = run(cli.main, argv)
    assert out == run(jcli.main, argv)
    lines = [json.loads(x) for x in out.splitlines()]
    assert [x["epoch"] for x in lines] == list(range(epoch, epoch + count))
    assert all(x["povw"] + x["staking"] == x["total"] for x in lines)


@pytest.mark.parametrize("epoch", [0, 1, 2])
def test_rewards_mint_equal_jax(tmp_path, epoch):
    log = tmp_path / "worklog.json"
    log.write_text(json.dumps([
        {"prover": "p1", "cycles": 3_000_000, "epoch": 0},
        {"prover": "p2", "cycles": 1_000_000, "epoch": 0,
         "claim_digest": "ab" * 32},
        {"prover": "p1", "cycles": 5, "epoch": 1},
        {"prover": "p3", "cycles": 7, "epoch": 1},
        {"prover": "p3", "cycles": 9, "epoch": 2},
    ]))
    argv = ["rewards", "mint", "--log", str(log), "--epoch", str(epoch),
            "--epoch-reward", "1000"]
    out = run(cli.main, argv)
    assert out == run(jcli.main, argv)
    if epoch == 0:
        assert json.loads(out) == {"p1": 750, "p2": 250}


def _golden_lines(po2=5):
    """The reference CLI's lines, from the JAX package's measured degrees
    (the golden) and its own budget formula."""
    from boundless_tpu.air import degree as JDA

    g = np.load(GOLDEN)
    n = 1 << po2
    lines = []
    for name in ("rv32im", "rv32i"):
        worst = int(g[f"{name}/degree"].max())
        lines.append(json.dumps(dict(
            air=name, constraints=len(g[f"{name}/degree"]), po2=po2,
            worst_degree=worst, worst_mult=round(worst / (n - 1), 3),
            declared=5, budget=JDA.degree_budget(po2), ok=True)))
    return "\n".join(lines) + "\n"


def test_audit_degrees_equals_jax_golden():
    out = run(cli.main, ["prover", "audit-degrees", "--device", "cpu"])
    assert out == _golden_lines()
    assert [json.loads(x)["air"] for x in out.splitlines()] == [
        "rv32im", "rv32i"]


@pytest.mark.slow
def test_audit_degrees_equals_jax_cli():
    out = run(cli.main, ["prover", "audit-degrees", "--device", "cpu"])
    assert out == run(jcli.main, ["prover", "audit-degrees"])


def test_audit_degrees_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((AssertionError, RuntimeError)):
        run(cli.main, ["prover", "audit-degrees", "--po2", "3"])


def test_generate_config_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the wizard reads it")
    with pytest.raises(RuntimeError, match="CUDA device"):
        run(cli.main, ["prover", "generate-config"])


@pytest.mark.slow
def test_bootstrap_verifier_bytes_equal_contracts(tmp_path):
    out = run(cli.main, ["prover", "bootstrap-verifier", "--seed",
                         "20260821", "--device", "cpu", "--out",
                         str(tmp_path)])
    assert json.loads(out.splitlines()[0])["seed"] == 20260821
    for name in ("Groth16Verifier.sol", "bootstrap.json"):
        with open(os.path.join(ROOT, "contracts", name), "rb") as f:
            assert (tmp_path / name).read_bytes() == f.read(), name
