"""The port's CUDA doctor (`python -m gitax_torch.doctor`) on the CPU:
gitax's four tests/test_doctor.py cases, with the card's checks injected
where gitax's run on jax's CPU backend, and the native probe's report."""

import io
import json
import os
import subprocess
import sys
import time
from contextlib import redirect_stdout

import pytest

from gitax_torch import doctor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# a healthy card, as the checks that need one would report it
HEALTHY = dict(backend_init=lambda: ["NVIDIA H100 80GB HBM3 (0)"],
               compute=lambda: "matmul OK", kernels=lambda: "5 kernels OK")


def _main(*argv, **inject):
    out = io.StringIO()
    with redirect_stdout(out):
        rc = doctor.main(list(argv), **inject)
    return rc, out.getvalue()


def test_doctor_healthy_passes():
    rc, out = _main(**HEALTHY)
    assert rc == 0, out
    assert "all required checks passed" in out
    for name in ("backend", "compute", "kernels", "cache", "tsv"):
        assert "[OK  ] {}".format(name) in out, out


def test_doctor_json_mode():
    rc, out = _main("--json", **HEALTHY)
    assert rc == 0, out
    payload = json.loads(out.strip().splitlines()[-1])
    assert payload["ok"] is True
    names = {c["name"]: c for c in payload["checks"]}
    assert names["backend"]["ok"] and names["tsv"]["ok"] and names["kernels"]["ok"]
    assert set(names) == {"backend", "compute", "kernels", "cache", "native", "vocab", "tsv"}
    assert not names["native"]["required"] and not names["vocab"]["required"]


def test_doctor_without_a_card_fails_without_hanging():
    """No CUDA (this machine): the backend check FAILs at once, the checks
    that need the card are skipped, and the others still run."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    t0 = time.time()
    r = subprocess.run([sys.executable, "-m", "gitax_torch.doctor"], capture_output=True,
                       text=True, timeout=300, cwd=REPO, env=env)
    assert r.returncode == 1, r.stdout + r.stderr
    assert time.time() - t0 < 120
    assert "[FAIL] backend" in r.stdout
    assert "skipped: backend unavailable" in r.stdout
    assert "[OK  ] tsv" in r.stdout  # post-backend checks still ran
    assert "jax" not in r.stdout + r.stderr


def test_check_backend_timeout_reports_instead_of_hanging():
    """A CUDA init that never returns (a wedged driver or card) is
    reported as a TimeoutError by the watchdog."""
    def never_returns():
        time.sleep(60)

    t0 = time.time()
    with pytest.raises(TimeoutError, match="unreachable"):
        doctor._check_backend(1.0, init_fn=never_returns)
    assert time.time() - t0 < 10


def test_native_probe_reports_each_library(tmp_path, monkeypatch):
    """The native check compiles and links a probe for libjpeg and for
    nvjpeg with the toolkit's nvcc; a compiler that refuses both reports
    them missing, and the check warns (it is optional)."""
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\necho 'fatal error: no such header' >&2\nexit 1\n")
    fake.chmod(0o755)
    probes = doctor.native_probe(str(fake))
    assert set(probes) == {"libjpeg", "nvjpeg"}
    assert all(v.startswith("missing (") and "no such header" in v for v in probes.values())
    ok = tmp_path / "ok" / "nvcc"
    ok.parent.mkdir()
    ok.write_text("#!/bin/sh\nexit 0\n")
    ok.chmod(0o755)
    assert all(v.startswith("found") for v in doctor.native_probe(str(ok)).values())
    probe = doctor.native_probe
    monkeypatch.setattr(doctor, "native_probe", lambda: probe(str(fake)))
    rc, out = _main(**HEALTHY)
    assert rc == 0 and "[warn] native   RuntimeError: libjpeg missing" in out, out
