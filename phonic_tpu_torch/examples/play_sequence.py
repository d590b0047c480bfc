"""Sample-accurate sequencing of two Samplers at 120 BPM: the analog of
reference examples/play-sequence.rs (port of ``examples/play_sequence.py``)."""

from .. import AhdsrConfig, GeneratorPlaybackOptions, Sampler
from .common import demo_buffer, make_parser, make_player


def main():
    args = make_parser("120 BPM sequence: metronome + bass").parse_args()
    player = make_player(args)
    sr = args.sample_rate
    beat = int(sr * 60 / 120)  # 120 BPM

    metronome = Sampler(demo_buffer(sr, freq=880.0, secs=0.2, decay=20.0),
                        GeneratorPlaybackOptions(voices=2))
    bass = Sampler(demo_buffer(sr, freq=110.0, secs=1.0, decay=1.0),
                   GeneratorPlaybackOptions(voices=4),
                   envelope=AhdsrConfig(attack=0.005, decay=0.2, sustain=0.5,
                                        release=0.2))
    met = player.play_generator(metronome)
    bas = player.play_generator(bass)

    bassline = [48, 48, 51, 53, 48, 48, 55, 53]
    for bar in range(2):
        for step in range(8):
            t = (bar * 8 + step) * beat // 2
            if step % 2 == 0:
                met.note_on(72 if step % 8 == 0 else 60, volume=0.6, at=t)
            nid = bas.note_on(bassline[step], volume=0.9, at=t)
            bas.note_off(nid, at=t + beat // 2 - sr // 50)

    player.run(duration_frames=2 * 8 * beat // 2 + sr)
    print(f"rendered {player.position} frames")
    player.close()


if __name__ == "__main__":
    main()
