"""Play a file (preloaded + streamed) with scheduled control: the analog of
reference examples/play-file.rs (port of ``examples/play_file.py``)."""

from .. import FilePlaybackOptions
from ..sources.streamed import StreamedFileSource
from .common import default_asset, make_parser, make_player


def main():
    p = make_parser("play a file with volume/pan/speed control")
    p.add_argument("file", nargs="?", default=None, help="WAV/AIFF to play")
    args = p.parse_args()
    player = make_player(args)

    src = args.file or default_asset(sr=args.sample_rate, secs=2.0)
    h = player.play_file(src, FilePlaybackOptions(volume=0.9, speed=1.0))
    h.set_volume(0.4, at=args.sample_rate)        # dip volume at 1 s
    h.set_panning(-0.8, at=args.sample_rate // 2)  # pan left at 0.5 s
    h.stop(at=int(1.8 * args.sample_rate))

    # a second, streamed instance, faster
    stream = StreamedFileSource(src, FilePlaybackOptions(
        volume=0.4, speed=1.5, start_time=args.sample_rate // 4))
    player.main_mixer.add_source(stream)

    player.run()
    print(player)
    print(f"rendered {player.position} frames, "
          f"cpu load avg {player.cpu_load().average:.4f}")
    player.close()


if __name__ == "__main__":
    main()
