"""BASELINE conformance runner (audio_raytracer_tpu.conformance): the
five enumerated configs must PASS through the one-command entry point.
Gate depth lives in the runner itself; this test
keeps the runner green in the CI lane (--fast sizes)."""

import pytest

from audio_raytracer_tpu.conformance import main


class TestConformance:
    def test_all_configs_pass_fast(self, capsys):
        rc = main(["--fast"])
        out = capsys.readouterr().out
        assert "conformance: 5/5 PASS" in out, out
        assert rc == 0
        for i in range(1, 6):
            assert f"config {i} [" in out and "]: PASS" in out, out

    def test_only_selection_and_failure_exit_code(self, capsys,
                                                  monkeypatch):
        # A failing gate must flip the exit code (the runner is a CI
        # gate, not a report).
        import audio_raytracer_tpu.conformance as conf

        monkeypatch.setitem(conf.CONFIGS, 1,
                            lambda args: (False, "injected failure"))
        rc = main(["--fast", "--only", "1"])
        out = capsys.readouterr().out
        assert rc == 1
        assert "conformance: 0/1 PASS" in out, out
