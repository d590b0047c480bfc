"""Interactive playback: terminal keyboard -> live note events, filter
sweeps and loop seeking through the realtime control plane (the analog of
reference examples/play-interactive.rs); port of
``examples/play_interactive.py``.

Keys:
  a s d f g h j   play notes C D E F G A B (hold polyphony, release on
                  the next press of the same key)
  z / x           octave down / up
  , / .           seek the background loop backward / forward
  1 / 2           switch note keys between the sub3 synth and the sampler
  [ / ]           filter cutoff down / up on the loop mixer
  m               toggle the loop filter type LP -> BP -> HP
  q or Esc        quit

Run with no arguments for the realtime device (ALSA via RtOutput, or a
realtime-paced NullOutput when no device is available).  ``--selftest``
injects a scripted key sequence without a tty: the CI-able smoke test of
the same control path.  With ``-o`` (selftest only) the script's keys land
at fixed frames, KEY_FRAMES apart, and the scene renders offline to a WAV
file of ``len(SCRIPT) * KEY_FRAMES + sample_rate`` frames.
"""

import select
import sys
import time

from .. import (AhdsrConfig, FilePlaybackOptions, GeneratorPlaybackOptions,
                Sampler, SynthGenerator, synths)
from ..effects.filter import FilterEffect
from ..effects.gain import GainEffect
from ..effects.reverb import ReverbEffect
from .common import demo_buffer, make_parser, make_player

NOTE_KEYS = {"a": 0, "s": 2, "d": 4, "f": 5, "g": 7, "h": 9, "j": 11}
FILTER_TYPES = ["Lowpass", "Bandpass", "Highpass"]
# the selftest's keys
SCRIPT = ["a", "s", "d", "2", "f", "g", "]", "]", "m", ".",
          "1", "h", "z", "j", "q"]


def key_frames(sr: int) -> int:
    """Frames between two scripted keys offline (0.12 s, as the live
    selftest's sleeps)."""
    return int(0.12 * sr)


class _RawTty:
    """Raw, non-blocking single-key reads (no external deps)."""

    def __enter__(self):
        import termios
        import tty

        self._fd = sys.stdin.fileno()
        self._saved = termios.tcgetattr(self._fd)
        tty.setcbreak(self._fd)
        return self

    def __exit__(self, *exc):
        import termios

        termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)

    def read_key(self, timeout=0.05):
        r, _, _ = select.select([sys.stdin], [], [], timeout)
        if not r:
            return None
        return sys.stdin.read(1)


def main():
    p = make_parser("interactive keyboard playback")
    p.add_argument("--selftest", action="store_true",
                   help="inject a scripted key sequence (no tty needed)")
    args = p.parse_args()
    if args.output and not args.selftest:
        raise SystemExit("the interactive example renders offline (-o) "
                         "only with --selftest")
    player = make_player(args)
    sr = args.sample_rate

    # background loop on its own mixer behind a filter
    loop_mixer = player.add_mixer()
    filt = FilterEffect(filter_type="Lowpass", cutoff=20000.0, q=0.707)
    loop_filter = loop_mixer.add_effect(filt)
    loop = player.play_file(
        demo_buffer(sr, freq=110.0, secs=2.0, decay=0.6),
        FilePlaybackOptions(repeat=None, volume=0.7, speed=0.9,
                            fade_out_secs=0.0),
        mixer=loop_mixer.mixer, stream=True)

    # tone mixer: synth + sampler into a reverb
    tone_mixer = player.add_mixer()
    tone_mixer.add_effect(ReverbEffect(room_size=0.6, wet=0.5))
    player.add_effect(GainEffect(gain=1.0, dc_mode="Default"))

    synth = SynthGenerator(synths.sub3(), GeneratorPlaybackOptions(voices=4),
                           release_secs=0.3)
    sampler = Sampler(demo_buffer(sr, freq=220.0, secs=1.0),
                      GeneratorPlaybackOptions(voices=8),
                      envelope=AhdsrConfig(attack=0.0, sustain=1.0,
                                           release=1.5))
    h_synth = player.play_generator(synth, mixer=tone_mixer.mixer)
    h_sampler = player.play_generator(sampler, mixer=tone_mixer.mixer)

    state = {
        "octave": 5, "mode": "synth", "cutoff": 20000.0, "ftype": 0,
        "held": {}, "seek": 0.0, "quit": False,
    }

    def on_key(ch, at=None):
        """One key's control events, now or (offline) at frame ``at``."""
        if ch in ("q", "\x1b"):
            state["quit"] = True
        elif ch in NOTE_KEYS:
            h = h_synth if state["mode"] == "synth" else h_sampler
            note = 12 * state["octave"] + NOTE_KEYS[ch]
            held = state["held"]
            if ch in held:
                hh, nid = held.pop(ch)
                hh.note_off(nid, at=at)
            held[ch] = (h, h.note_on(note, volume=0.7, at=at))
        elif ch == "z":
            state["octave"] = max(state["octave"] - 1, 1)
        elif ch == "x":
            state["octave"] = min(state["octave"] + 1, 8)
        elif ch == "1":
            state["mode"] = "synth"
        elif ch == "2":
            state["mode"] = "sampler"
        elif ch in (",", "."):
            state["seek"] = max(
                state["seek"] + (0.25 if ch == "." else -0.25) * sr, 0.0)
            loop.seek(state["seek"], at=at)
        elif ch in ("[", "]"):
            factor = 1.25 if ch == "]" else 0.8
            state["cutoff"] = min(max(state["cutoff"] * factor, 100.0), 20000.0)
            loop_filter.set_parameter("cuto", state["cutoff"], at=at)
        elif ch == "m":
            state["ftype"] = (state["ftype"] + 1) % len(FILTER_TYPES)
            loop_filter.set_parameter(
                "type", FILTER_TYPES[state["ftype"]], at=at)

    if args.output:
        step = key_frames(sr)
        for i, ch in enumerate(SCRIPT):
            on_key(ch, at=(i + 1) * step)
        player.run(duration_frames=len(SCRIPT) * step + sr)
        lvl = player.audio_level()
        print(f"selftest ok: {player.position} frames, peak={lvl.peak}")
        assert lvl.peak is not None and float(max(lvl.peak)) > 1e-4
        player.close()
        return

    pump = player.run_async()
    print(__doc__)

    if args.selftest:
        # wait out the first render before scripting keys
        t0 = time.time()
        while player.position == 0 and time.time() - t0 < 300:
            time.sleep(0.25)
        assert player.position > 0, "pump never rendered"
        for ch in SCRIPT:
            on_key(ch)
            time.sleep(0.12)
        time.sleep(1.0)  # let the scripted notes become audible
        player.stop()
        lvl = player.audio_level()
        print(f"selftest ok: {player.position} frames, peak={lvl.peak}")
        assert lvl.peak is not None and float(max(lvl.peak)) > 1e-4
    else:
        if not sys.stdin.isatty():
            raise SystemExit("stdin is not a tty; use --selftest")
        with _RawTty() as tty_in:
            while not state["quit"]:
                ch = tty_in.read_key()
                if ch is not None:
                    on_key(ch)
        player.stop()
    del pump
    player.close()


if __name__ == "__main__":
    main()
