// Native FLAC frame decoder — the hot inner loop of io/flac.py.
//
// The Python decoder (io/flac.py) is the readable spec: bit-exact FLAC
// subset per the format spec (constant/verbatim/fixed/LPC subframes, Rice
// partitions incl. escapes, wasted bits, stereo decorrelation).  Decoding
// per-sample in Python runs ~2.6x realtime, far too slow for the streaming
// path (reference: symphonia's native decode feeding the 128 Ki ring,
// src/source/file/streamed.rs:522-567).  This file implements ONE frame
// decode natively; Python keeps all file/metadata handling, and its own
// loop is the reference the tests hold this decoder against.
//
//   ph_flac_frame(data, len, &byte_off, channels, bps, out, out_stride)
//     -> blocksize (>0), 0 on clean EOF (no full frame), -1 on error
//
// out is planar int32 [channels][out_stride]; byte_off advances to the
// first byte after the frame (frames are byte-aligned).  Thread-safe: no
// global state.

#include <cstdint>
#include <cstring>

namespace {

struct BitReader {
    const uint8_t* d;
    uint64_t len;     // bytes
    uint64_t pos;     // bits
    bool fail = false;

    uint32_t bits(uint32_t n) {
        // n <= 32
        uint32_t v = 0;
        while (n > 0) {
            if (pos >= len * 8) { fail = true; return 0; }
            uint32_t byte_i = (uint32_t)(pos >> 3);
            uint32_t bit_i = (uint32_t)(pos & 7);
            uint32_t avail = 8 - bit_i;
            uint32_t take = n < avail ? n : avail;
            uint32_t chunk = (d[byte_i] >> (avail - take)) & ((1u << take) - 1u);
            v = (v << take) | chunk;
            pos += take;
            n -= take;
        }
        return v;
    }

    int64_t sbits(uint32_t n) {
        if (n == 0) return 0;
        uint64_t v = 0;
        uint32_t left = n;
        while (left > 32) { v = (v << 32) | bits(32); left -= 32; }
        v = (v << left) | bits(left);
        // sign extend from n bits
        uint64_t sign = 1ull << (n - 1);
        return (int64_t)((v ^ sign) - sign);
    }

    uint32_t unary() {
        uint32_t q = 0;
        while (true) {
            if (pos >= len * 8) { fail = true; return q; }
            uint32_t byte_i = (uint32_t)(pos >> 3);
            uint32_t bit_i = (uint32_t)(pos & 7);
            uint8_t rest = (uint8_t)(d[byte_i] << bit_i);
            if (rest == 0) {  // all zeros to byte end
                q += 8 - bit_i;
                pos += 8 - bit_i;
                continue;
            }
            // count leading zeros in the remaining bits of this byte
            uint32_t lz = 0;
            for (uint8_t m = 0x80; (rest & m) == 0; m >>= 1) lz++;
            q += lz;
            pos += lz + 1;  // consume the terminating 1
            return q;
        }
    }

    uint64_t utf8_number() {
        uint32_t b0 = bits(8);
        if (b0 < 0x80) return b0;
        uint32_t n = 0;
        for (uint32_t m = 0x80; b0 & m; m >>= 1) n++;
        uint64_t v = b0 & (0x7Fu >> n);
        for (uint32_t i = 1; i < n; i++) v = (v << 6) | (bits(8) & 0x3F);
        return v;
    }

    void align() { pos = (pos + 7) & ~7ull; }
    bool eof() const { return pos >= len * 8; }
};

constexpr int MAX_BLOCK = 65536;

// decode one subframe into x[0..blocksize)
bool read_subframe(BitReader& br, uint32_t blocksize, int bps, int64_t* x) {
    if (br.bits(1) != 0) return false;  // padding bit
    uint32_t ftype = br.bits(6);
    uint32_t wasted = 0;
    if (br.bits(1)) {
        wasted = br.unary() + 1;
        bps -= (int)wasted;
    }
    if (bps <= 0 || bps > 33) return false;

    auto read_residual = [&](uint32_t order, int64_t* res) -> bool {
        uint32_t method = br.bits(2);
        if (method > 1) return false;
        uint32_t pbits = method == 0 ? 4 : 5;
        uint32_t escape = method == 0 ? 0xF : 0x1F;
        uint32_t po = br.bits(4);
        uint32_t parts = 1u << po;
        if (blocksize % parts != 0) return false;
        uint32_t plen = blocksize >> po;
        uint32_t idx = 0;
        for (uint32_t p = 0; p < parts; p++) {
            uint32_t count = plen - (p == 0 ? order : 0);
            uint32_t param = br.bits(pbits);
            if (param == escape) {
                uint32_t raw = br.bits(5);
                for (uint32_t i = 0; i < count; i++)
                    res[idx++] = raw ? br.sbits(raw) : 0;
            } else {
                for (uint32_t i = 0; i < count; i++) {
                    uint64_t q = br.unary();
                    uint64_t u = param ? ((q << param) | br.bits(param)) : q;
                    res[idx++] = (int64_t)(u >> 1) ^ -(int64_t)(u & 1);
                }
            }
            if (br.fail) return false;
        }
        return true;
    };

    if (ftype == 0) {  // constant
        int64_t v = br.sbits(bps);
        for (uint32_t i = 0; i < blocksize; i++) x[i] = v;
    } else if (ftype == 1) {  // verbatim
        for (uint32_t i = 0; i < blocksize; i++) x[i] = br.sbits(bps);
    } else if (ftype >= 8 && ftype <= 12) {  // fixed, order 0-4
        uint32_t order = ftype - 8;
        for (uint32_t i = 0; i < order; i++) x[i] = br.sbits(bps);
        if (!read_residual(order, x + order)) return false;
        switch (order) {
            case 0: break;
            case 1:
                for (uint32_t i = 1; i < blocksize; i++) x[i] += x[i - 1];
                break;
            case 2:
                for (uint32_t i = 2; i < blocksize; i++)
                    x[i] += 2 * x[i - 1] - x[i - 2];
                break;
            case 3:
                for (uint32_t i = 3; i < blocksize; i++)
                    x[i] += 3 * x[i - 1] - 3 * x[i - 2] + x[i - 3];
                break;
            case 4:
                for (uint32_t i = 4; i < blocksize; i++)
                    x[i] += 4 * x[i - 1] - 6 * x[i - 2] + 4 * x[i - 3] - x[i - 4];
                break;
        }
    } else if (ftype >= 32) {  // LPC, order 1-32
        uint32_t order = (ftype & 0x1F) + 1;
        for (uint32_t i = 0; i < order; i++) x[i] = br.sbits(bps);
        uint32_t prec = br.bits(4) + 1;
        if (prec > 16) return false;
        int shift = (int)br.sbits(5);
        if (shift < 0) return false;
        int64_t coeffs[32];
        for (uint32_t i = 0; i < order; i++) coeffs[i] = br.sbits(prec);
        if (!read_residual(order, x + order)) return false;
        for (uint32_t i = order; i < blocksize; i++) {
            int64_t acc = 0;
            for (uint32_t j = 0; j < order; j++) acc += coeffs[j] * x[i - 1 - j];
            x[i] += acc >> shift;
        }
    } else {
        return false;
    }
    if (wasted)
        for (uint32_t i = 0; i < blocksize; i++) x[i] <<= wasted;
    return !br.fail;
}

const uint32_t BLOCKSIZES[16] = {0, 192, 576, 1152, 2304, 4608, 0, 0,
                                 256, 512, 1024, 2048, 4096, 8192, 16384, 32768};
const uint32_t RATE_OK[16] = {1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0};
const int BPS_TAB[8] = {0, 8, 12, 0, 16, 20, 24, 32};

}  // namespace

extern "C" int ph_flac_frame(const uint8_t* data, uint64_t len,
                             uint64_t* byte_off, uint32_t channels,
                             uint32_t bps, int32_t* out,
                             uint32_t out_stride) {
    static thread_local int64_t sub[2 + 8][MAX_BLOCK > 0 ? MAX_BLOCK : 1];
    if (channels == 0 || channels > 8) return -1;
    BitReader br{data, len, *byte_off * 8};
    if (br.eof()) return 0;
    uint32_t sync = br.bits(14);
    if (br.fail) return 0;  // ran off the end looking for a frame: EOF
    if (sync != 0x3FFE) return -1;
    br.bits(1);  // reserved
    br.bits(1);  // blocking strategy
    uint32_t bs_code = br.bits(4);
    uint32_t sr_code = br.bits(4);
    uint32_t ch_code = br.bits(4);
    uint32_t bps_code = br.bits(3);
    br.bits(1);  // reserved
    br.utf8_number();
    uint32_t blocksize;
    if (bs_code == 6) blocksize = br.bits(8) + 1;
    else if (bs_code == 7) blocksize = br.bits(16) + 1;
    else if (BLOCKSIZES[bs_code]) blocksize = BLOCKSIZES[bs_code];
    else return -1;
    if (blocksize > MAX_BLOCK) return -1;
    if (sr_code == 12) br.bits(8);
    else if (sr_code == 13 || sr_code == 14) br.bits(16);
    else if (sr_code != 0 && !RATE_OK[sr_code]) return -1;
    int fbps = BPS_TAB[bps_code & 7] ? BPS_TAB[bps_code & 7] : (int)bps;
    br.bits(8);  // header CRC-8 (not verified, matching io/flac.py)

    if (ch_code < 8) {
        if (ch_code + 1 != channels) return -1;
        for (uint32_t c = 0; c < channels; c++)
            if (!read_subframe(br, blocksize, fbps, sub[c])) return -1;
        for (uint32_t c = 0; c < channels; c++)
            for (uint32_t i = 0; i < blocksize; i++)
                out[c * out_stride + i] = (int32_t)sub[c][i];
    } else if (ch_code <= 10) {
        if (channels != 2) return -1;
        int64_t* a = sub[0];
        int64_t* b = sub[1];
        if (ch_code == 8) {  // left/side
            if (!read_subframe(br, blocksize, fbps, a)) return -1;
            if (!read_subframe(br, blocksize, fbps + 1, b)) return -1;
            for (uint32_t i = 0; i < blocksize; i++) {
                out[i] = (int32_t)a[i];
                out[out_stride + i] = (int32_t)(a[i] - b[i]);
            }
        } else if (ch_code == 9) {  // right/side
            if (!read_subframe(br, blocksize, fbps + 1, a)) return -1;
            if (!read_subframe(br, blocksize, fbps, b)) return -1;
            for (uint32_t i = 0; i < blocksize; i++) {
                out[i] = (int32_t)(b[i] + a[i]);
                out[out_stride + i] = (int32_t)b[i];
            }
        } else {  // mid/side
            if (!read_subframe(br, blocksize, fbps, a)) return -1;
            if (!read_subframe(br, blocksize, fbps + 1, b)) return -1;
            for (uint32_t i = 0; i < blocksize; i++) {
                int64_t l = ((a[i] << 1) | (b[i] & 1)) + b[i];
                out[i] = (int32_t)(l >> 1);
                out[out_stride + i] = (int32_t)((l - (b[i] << 1)) >> 1);
            }
        }
    } else {
        return -1;
    }
    br.align();
    br.bits(16);  // frame CRC-16 (not verified)
    if (br.fail) return -1;
    *byte_off = br.pos >> 3;
    return (int)blocksize;
}

// ---------------------------------------------------------------------------
// ALAC packet decode — the hot inner loop of io/alac.py (decode_packet).
// Spec-by-code: Apple's published ALACDecoder.cpp / ag_dec.cpp / dp_dec.cpp;
// io/alac.py is the readable Python spec and the fallback, and the suite
// asserts both paths decode identically.
//
//   ph_alac_packet(pkt, len, frame_length, bit_depth, pb, mb, kb,
//                  out, out_stride, max_ch, &channels)
//     -> nb_samples (>=0), -1 on error, -2 on unsupported element
// ---------------------------------------------------------------------------

namespace {

struct AlacBits {
    const uint8_t* d;
    uint64_t len;
    uint64_t pos = 0;  // bits
    bool fail = false;

    uint32_t bits(uint32_t n) {
        if (n == 0) return 0;
        uint32_t v = 0;
        uint32_t left = n;
        while (left > 0) {
            if (pos >= len * 8) { fail = true; return 0; }
            uint32_t byte_i = (uint32_t)(pos >> 3);
            uint32_t bit_i = (uint32_t)(pos & 7);
            uint32_t avail = 8 - bit_i;
            uint32_t take = left < avail ? left : avail;
            uint32_t chunk = (d[byte_i] >> (avail - take)) & ((1u << take) - 1u);
            v = (v << take) | chunk;
            pos += take;
            left -= take;
        }
        return v;
    }
    int64_t sbits(uint32_t n) {
        uint64_t v = bits(n);
        uint64_t sign = 1ull << (n - 1);
        return (int64_t)((v ^ sign) - sign);
    }
    uint32_t show(uint32_t n) {
        uint64_t save = pos;
        bool f = fail;
        uint32_t v = bits(n);
        pos = save;
        fail = f;
        return v;
    }
};

inline int alac_log2(uint32_t v) { return v ? 31 - __builtin_clz(v) : 0; }

inline int64_t alac_sext(int64_t v, uint32_t b) {
    uint64_t m = (b >= 64) ? ~0ull : ((1ull << b) - 1);
    uint64_t u = (uint64_t)v & m;
    uint64_t sign = 1ull << (b - 1);
    return (int64_t)((u ^ sign) - sign);
}

uint32_t alac_decode_scalar(AlacBits& br, uint32_t k, uint32_t bps) {
    uint32_t x = 0;
    while (x <= 8 && br.bits(1)) x++;
    if (x > 8) return br.bits(bps);
    if (k != 1) {
        uint32_t extra = br.show(k);
        x = (x << k) - x;
        if (extra > 1) { x += extra - 1; br.pos += k; }
        else br.pos += k - 1;
    }
    return x;
}

bool alac_rice_decompress(AlacBits& br, int64_t* out, uint32_t n,
                          uint32_t bps, uint32_t mult, uint32_t mb,
                          uint32_t kb) {
    uint32_t history = mb;
    uint32_t sign_modifier = 0;
    for (uint32_t i = 0; i < n; i++) {
        uint32_t k = alac_log2((history >> 9) + 3);
        if (k > kb) k = kb;
        uint32_t x = alac_decode_scalar(br, k, bps) + sign_modifier;
        if (br.fail) return false;
        sign_modifier = 0;
        out[i] = (int64_t)(x >> 1) ^ -(int64_t)(x & 1);
        if (x > 0xFFFF) history = 0xFFFF;
        else history += x * mult - ((history * mult) >> 9);
        if (history < 128 && i + 1 < n) {
            uint32_t k2 = 7 - alac_log2(history) + ((history + 16) >> 6);
            if (k2 > kb) k2 = kb;
            uint32_t run = alac_decode_scalar(br, k2, 16);
            if (br.fail) return false;
            if (run > 0) {
                if (run > n - i - 1) return false;
                for (uint32_t j = 0; j < run; j++) out[i + 1 + j] = 0;
                i += run;
            }
            if (run <= 0xFFFF) sign_modifier = 1;
            history = 0;
        }
    }
    return true;
}

void alac_lpc(int64_t* x /* in: err, out: samples (in place) */, uint32_t n,
              uint32_t bps, int16_t* coefs, uint32_t order, uint32_t quant) {
    if (n == 0) return;
    if (order == 0) return;  // err already equals output
    if (order == 31) {
        for (uint32_t i = 1; i < n; i++)
            x[i] = alac_sext(x[i - 1] + x[i], bps);
        return;
    }
    uint32_t warm = order + 1 < n ? order + 1 : n;
    for (uint32_t i = 1; i < warm; i++)
        x[i] = alac_sext(x[i - 1] + x[i], bps);
    int32_t c[32];
    for (uint32_t j = 0; j < order; j++) c[j] = coefs[j];
    for (uint32_t i = order + 1; i < n; i++) {
        int64_t d = x[i - order - 1];
        int64_t val = 0;
        for (uint32_t j = 0; j < order; j++)
            val += (x[i - order + j] - d) * c[j];
        val = (val + (1ll << (quant - 1))) >> quant;
        int64_t error_val = x[i];  // residual
        x[i] = alac_sext(val + d + error_val, bps);
        if (error_val > 0) {
            for (uint32_t j = 0; j < order && error_val > 0; j++) {
                int64_t v = d - x[i - order + j];
                int64_t sign = (v > 0) - (v < 0);
                c[j] -= (int32_t)sign;
                v *= sign;
                error_val -= (v >> quant) * (int64_t)(j + 1);
            }
        } else if (error_val < 0) {
            for (uint32_t j = 0; j < order && error_val < 0; j++) {
                int64_t v = d - x[i - order + j];
                int64_t sign = (v > 0) - (v < 0);
                c[j] += (int32_t)sign;
                v *= sign;
                error_val -= ((-v) >> quant) * (int64_t)(j + 1);
            }
        }
    }
}

constexpr uint32_t ALAC_MAX_FRAME = 1u << 20;

}  // namespace

extern "C" int ph_alac_packet(const uint8_t* pkt, uint64_t len,
                              uint32_t frame_length, uint32_t bit_depth,
                              uint32_t pb, uint32_t mb, uint32_t kb,
                              int32_t* out, uint32_t out_stride,
                              uint32_t max_ch, uint32_t* out_channels) {
    AlacBits br{pkt, len};
    uint32_t total_ch = 0;
    uint32_t nb_samples = frame_length;
    // scratch: per element up to 2 channels
    static thread_local int64_t* buf[2] = {nullptr, nullptr};
    static thread_local int64_t* extra_buf = nullptr;
    if (!buf[0]) {
        buf[0] = new int64_t[ALAC_MAX_FRAME];
        buf[1] = new int64_t[ALAC_MAX_FRAME];
        extra_buf = new int64_t[2 * ALAC_MAX_FRAME];
    }
    while (true) {
        uint32_t tag = br.bits(3);
        if (br.fail) return -1;
        if (tag == 7) break;           // ID_END
        if (tag == 4 || tag == 5 || tag == 6) return -2;  // DSE/PCE/FIL-ish
        if (tag != 0 && tag != 1 && tag != 3) return -1;  // SCE/CPE/LFE only
        uint32_t channels = (tag == 1) ? 2 : 1;
        br.bits(4);                    // element instance tag
        if (br.bits(12) != 0) return -1;
        uint32_t has_size = br.bits(1);
        uint32_t extra_bits = br.bits(2) << 3;
        uint32_t is_verbatim = br.bits(1);
        uint32_t out_samples = has_size ? br.bits(32) : frame_length;
        if (out_samples > ALAC_MAX_FRAME || out_samples > out_stride)
            return -1;
        uint32_t bps = bit_depth - extra_bits + channels - 1;
        if (total_ch + channels > max_ch) return -1;
        if (!is_verbatim) {
            uint32_t decorr_shift = br.bits(8);
            uint32_t decorr_left_weight = br.bits(8);
            uint32_t pred_type[2], quant[2], hist_mult[2], order[2];
            int16_t coefs[2][32];
            for (uint32_t ch = 0; ch < channels; ch++) {
                pred_type[ch] = br.bits(4);
                quant[ch] = br.bits(4);
                hist_mult[ch] = br.bits(3);
                uint32_t o = br.bits(5);
                order[ch] = o;
                for (int i = (int)o - 1; i >= 0; i--)  // stream reversed
                    coefs[ch][i] = (int16_t)br.sbits(16);
            }
            if (extra_bits) {
                for (uint32_t i = 0; i < out_samples; i++)
                    for (uint32_t ch = 0; ch < channels; ch++)
                        extra_buf[ch * ALAC_MAX_FRAME + i] = br.bits(extra_bits);
            }
            for (uint32_t ch = 0; ch < channels; ch++) {
                if (!alac_rice_decompress(br, buf[ch], out_samples, bps,
                                          (hist_mult[ch] * pb) / 4, mb, kb))
                    return -1;
                if (pred_type[ch] == 15)
                    alac_lpc(buf[ch], out_samples, bps, nullptr, 31, 0);
                alac_lpc(buf[ch], out_samples, bps, coefs[ch], order[ch],
                         quant[ch]);
            }
            if (channels == 2 && decorr_left_weight) {
                for (uint32_t i = 0; i < out_samples; i++) {
                    int64_t a = buf[0][i] -
                        ((buf[1][i] * (int64_t)decorr_left_weight)
                         >> decorr_shift);
                    int64_t b = buf[1][i] + a;
                    buf[0][i] = b;
                    buf[1][i] = a;
                }
            }
            if (extra_bits) {
                for (uint32_t ch = 0; ch < channels; ch++)
                    for (uint32_t i = 0; i < out_samples; i++)
                        buf[ch][i] = (buf[ch][i] << extra_bits) |
                                     extra_buf[ch * ALAC_MAX_FRAME + i];
            }
            for (uint32_t ch = 0; ch < channels; ch++)
                for (uint32_t i = 0; i < out_samples; i++)
                    out[(total_ch + ch) * out_stride + i] =
                        (int32_t)buf[ch][i];
        } else {
            for (uint32_t i = 0; i < out_samples; i++)
                for (uint32_t ch = 0; ch < channels; ch++)
                    out[(total_ch + ch) * out_stride + i] =
                        (int32_t)br.sbits(bit_depth);
        }
        if (br.fail) return -1;
        total_ch += channels;
        nb_samples = out_samples;
    }
    *out_channels = total_ch;
    return (int)nb_samples;
}
