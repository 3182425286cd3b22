"""chip_smoke.py's ``--log FILE``: every line the smoke prints also goes to
FILE (for runners that keep only the end of the output); without it the
smoke prints as before, and without a card it exits 2 having printed no
result."""

import chip_smoke


def test_log_option_copies_every_printed_line(tmp_path, monkeypatch, capsys):
    def run(args):
        chip_smoke.say("3 kernels", case="a")
        print('{"ok": true}')
        return 0

    monkeypatch.setattr(chip_smoke, "run", run)
    log = tmp_path / "out" / "smoke.log"
    assert chip_smoke.main(["--log", str(log)]) == 0
    out = capsys.readouterr().out
    assert out == '[3 kernels] case=a\n{"ok": true}\n'
    assert log.read_text() == out
    assert chip_smoke.main([]) == 0
    assert capsys.readouterr().out == out


def test_without_a_card_the_smoke_exits_2_and_prints_no_result(tmp_path, capsys):
    log = tmp_path / "smoke.log"
    assert chip_smoke.main(["--log", str(log)]) == 2
    captured = capsys.readouterr()
    assert captured.out == "" and "CUDA is not available" in captured.err
    assert log.read_text() == ""
