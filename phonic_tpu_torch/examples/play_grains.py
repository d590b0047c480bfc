"""Granular Sampler with LFO/velocity/keytrack modulation: the analog of
reference examples/play-grains.rs (port of ``examples/play_grains.py``)."""

from .. import AhdsrConfig, GranularConfig, Sampler
from .common import demo_buffer, make_parser, make_player


def main():
    args = make_parser("granular playback with modulation").parse_args()
    player = make_player(args)
    sr = args.sample_rate

    sampler = Sampler(
        demo_buffer(sr, freq=220.0, secs=2.0, decay=0.5),
        envelope=AhdsrConfig(attack=0.3, release=0.5),
    ).with_granular_playback(GranularConfig(
        size_ms=120.0, density_hz=25.0, variation=0.4, spray=0.15,
        pan_spread=0.8, position=0.2, step=0.5, window="Hann",
    ))
    sampler.set_modulation("LFO1", "GPOS", 0.3, bipolar=True)
    sampler.set_modulation("LFO2", "GSIZ", 0.4, bipolar=True)
    sampler.set_modulation("VELM", "GDEN", 0.5, bipolar=False)
    sampler.set_modulation("KEYM", "GPAN", 0.6, bipolar=True)

    h = player.play_generator(sampler)
    a = h.note_on(57, volume=0.9, at=0)
    b = h.note_on(64, volume=0.6, at=sr)
    h.note_off(a, at=3 * sr)
    h.note_off(b, at=3 * sr)

    player.run(duration_frames=4 * sr)
    print(f"rendered {player.position} frames")
    player.close()


if __name__ == "__main__":
    main()
