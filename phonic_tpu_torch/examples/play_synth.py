"""Polyphonic synths (dx7 / organ / sub3): the analog of reference
examples/play-synth.rs (port of ``examples/play_synth.py``)."""

from .. import GeneratorPlaybackOptions, SynthGenerator, synths
from .common import make_parser, make_player


def main():
    p = make_parser("polyphonic synth demo")
    p.add_argument("--synth", choices=["dx7", "organ", "sub3"], default="dx7")
    args = p.parse_args()
    player = make_player(args)
    sr = args.sample_rate

    synth = {"dx7": synths.dx7, "organ": synths.organ,
             "sub3": synths.sub3}[args.synth]()
    gen = SynthGenerator(synth, GeneratorPlaybackOptions(voices=8),
                         release_secs=0.3)
    h = player.play_generator(gen)

    chord = [60, 64, 67, 71]
    for i, note in enumerate(chord):
        nid = h.note_on(note, volume=0.5, at=i * sr // 4)
        h.note_off(nid, at=2 * sr + i * sr // 8)

    player.run(duration_frames=3 * sr)
    print(f"rendered {player.position} frames with {args.synth}")
    player.close()


if __name__ == "__main__":
    main()
