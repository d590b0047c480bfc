"""render_rate (audio_s/s, host clock): every lane's audio-seconds that
reached the host in the measured window, over the window's wall seconds
(from the end of the warm-up to the arrival of the last block)."""


def read(r):
    frames = r.lanes * r.window_blocks * r.mix["block_frames"]
    return frames / r.sample_rate / (r.t1 - r.t0)
