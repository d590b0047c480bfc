"""Browser playback: stream the live render over HTTP (the analog of the
reference's emscripten/WebAudio example, examples/play-emscripten/); port
of ``examples/play_web.py``.

Starts a WebOutput HTTP server and plays a synth sequence through it; open
the printed URL in any browser: the page's <audio> element plays the
endless float32 WAV stream.  With ``-o`` the same scene renders offline
to a WAV file instead, ``--seconds`` long (4 s when not given).
"""

import time

from .. import (FilePlaybackOptions, GeneratorPlaybackOptions,
                SynthGenerator, synths)
from ..outputs.web import WebOutput
from .common import demo_buffer, make_parser, make_player


def main():
    p = make_parser("browser playback over HTTP")
    p.add_argument("--port", type=int, default=8765)
    p.add_argument("--seconds", type=float, default=0.0,
                   help="stop after N seconds (0 = run until Ctrl-C)")
    args = p.parse_args()

    out = None if args.output else WebOutput(args.sample_rate, 2,
                                             host="0.0.0.0", port=args.port)
    player = make_player(args, out)

    player.play_file(demo_buffer(args.sample_rate, freq=110.0, secs=2.0,
                                 decay=0.5),
                     FilePlaybackOptions(repeat=None, volume=0.5,
                                         fade_out_secs=0.0))
    gen = SynthGenerator(synths.organ(), GeneratorPlaybackOptions(voices=4),
                         release_secs=0.4)
    h = player.play_generator(gen)
    sr = args.sample_rate
    for bar in range(64):
        base = bar * 2 * sr
        for i, note in enumerate((60, 64, 67, 64)):
            t0 = base + i * sr // 2
            nid = h.note_on(note, volume=0.5, at=t0)
            h.note_off(nid, at=t0 + sr // 3)

    if args.output:
        player.run(duration_frames=int((args.seconds or 4.0) * sr))
        print(f"rendered {player.position} frames")
        player.close()
        return
    player.run_async()
    print(f"streaming at {out.url}  (open in a browser; Ctrl-C stops)")
    try:
        if args.seconds > 0:
            time.sleep(args.seconds)
        else:
            while True:
                time.sleep(1.0)
    except KeyboardInterrupt:
        pass
    player.close()


if __name__ == "__main__":
    main()
