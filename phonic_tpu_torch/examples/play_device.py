"""Output-device picker: the analog of reference examples/play-device.rs
(port of ``examples/play_device.py``): list the available ALSA playback
devices and play a tone on a chosen one, or render offline with -o like
every example.  ``--device`` names the torch device here, as in every port
example; the ALSA PCM is ``--pcm``."""

from .. import FilePlaybackOptions
from ..outputs import NullOutput, WavOutput
from ..outputs.rt import (RtOutput, alsa_available, list_alsa_devices,
                          rt_available)
from .common import demo_buffer, make_parser, make_player


def main():
    p = make_parser("output device picker")
    p.add_argument("--pcm", default="",
                   help="ALSA PCM name from the printed list (default: 'default')")
    p.add_argument("--list", action="store_true", help="list devices and exit")
    args = p.parse_args()

    devices = list_alsa_devices()
    if devices:
        print(f"{len(devices)} ALSA playback devices:")
        for name, desc in devices:
            print(f"  {name:32s} {desc}")
    else:
        print("no ALSA devices available"
              + ("" if alsa_available() else " (libasound not found)"))
    if args.list:
        return

    if args.output:
        out = WavOutput(args.output, args.sample_rate, 2)
    elif rt_available():
        out = RtOutput(args.sample_rate, 2, device=args.pcm)
        print(f"playing on {args.pcm or 'default'!r} "
              f"(alsa={'yes' if out.uses_alsa else 'no, null sink'})")
    else:
        out = NullOutput(args.sample_rate, 2, realtime=True)
    player = make_player(args, out)
    player.play_file(demo_buffer(args.sample_rate, freq=440.0, secs=1.5),
                     FilePlaybackOptions(fade_out_secs=0.0))
    player.run(duration_frames=2 * args.sample_rate)
    out.close()
    print(f"rendered {out.sample_position} frames")


if __name__ == "__main__":
    main()
