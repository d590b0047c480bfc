// Native realtime bridge: lock-free SPSC audio ring buffer + paced consumer.
//
// Behavioural spec: the reference's realtime edge is a CPAL audio callback
// pulling a Source with assert_no_alloc guards (reference:
// src/output/cpal.rs:616-724) and an SPSC ring between decoder and audio
// threads (src/source/file/streamed.rs:522-524).  Here the accelerator
// renders blocks ahead of time; this bridge owns the real-time side:
//
//   producer (Python render pump) --ph_ring_write--> ring --consumer thread-->
//      ALSA (dlopen'd libasound, when present) or a wall-clock-paced sink.
//
// The consumer thread never allocates after start; the ring is power-of-two
// masked with acquire/release atomics (single producer, single consumer).
//
// Build: g++ -O2 -fPIC -std=c++17 -shared ringbuf.cpp -lpthread -ldl, done
// by outputs/rt.py at first use (into the package's _build/ directory).

#include <atomic>
#include <chrono>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <cstdio>
#include <cmath>
#include <cerrno>
#include <dlfcn.h>
#include <pthread.h>
#include <sched.h>
#include <thread>
#include <unistd.h>

namespace {

// ---- minimal ALSA surface, resolved at runtime ---------------------------
struct AlsaApi {
    void* lib = nullptr;
    int (*open_)(void**, const char*, int, int) = nullptr;
    int (*set_params)(void*, int, int, unsigned, unsigned, int, unsigned) = nullptr;
    long (*writei)(void*, const void*, unsigned long) = nullptr;
    int (*recover)(void*, int, int) = nullptr;
    int (*close_)(void*) = nullptr;
    // device enumeration (optional symbols)
    int (*name_hint)(int, const char*, void***) = nullptr;
    char* (*get_hint)(const void*, const char*) = nullptr;
    int (*free_hint)(void**) = nullptr;

    bool load() {
        lib = dlopen("libasound.so.2", RTLD_NOW | RTLD_LOCAL);
        if (!lib) return false;
        open_ = (int (*)(void**, const char*, int, int))dlsym(lib, "snd_pcm_open");
        set_params = (int (*)(void*, int, int, unsigned, unsigned, int, unsigned))
            dlsym(lib, "snd_pcm_set_params");
        writei = (long (*)(void*, const void*, unsigned long))dlsym(lib, "snd_pcm_writei");
        recover = (int (*)(void*, int, int))dlsym(lib, "snd_pcm_recover");
        close_ = (int (*)(void*))dlsym(lib, "snd_pcm_close");
        name_hint = (int (*)(int, const char*, void***))
            dlsym(lib, "snd_device_name_hint");
        get_hint = (char* (*)(const void*, const char*))
            dlsym(lib, "snd_device_name_get_hint");
        free_hint = (int (*)(void**))dlsym(lib, "snd_device_name_free_hint");
        return open_ && set_params && writei && recover && close_;
    }
};

constexpr int SND_PCM_STREAM_PLAYBACK = 0;
constexpr int SND_PCM_FORMAT_S16_LE = 2;
constexpr int SND_PCM_FORMAT_S32_LE = 10;
constexpr int SND_PCM_FORMAT_FLOAT_LE = 14;
constexpr int SND_PCM_ACCESS_RW_INTERLEAVED = 3;

struct Ring {
    float* data = nullptr;          // interleaved f32
    uint32_t capacity_frames = 0;   // power of two
    uint32_t mask = 0;
    uint32_t channels = 2;
    uint32_t sample_rate = 48000;
    std::atomic<uint64_t> write_pos{0};  // frames produced
    std::atomic<uint64_t> read_pos{0};   // frames consumed
    std::atomic<bool> running{true};
    std::atomic<bool> paused{false};
    std::thread consumer;
    AlsaApi alsa;
    void* pcm = nullptr;
    bool use_alsa = false;
    // negotiated device sample format (reference dispatches i8..f64 with an
    // f32 fast path, src/output/cpal.rs:509-561; FLOAT_LE is tried first,
    // then S32_LE, then S16_LE — the formats real ALSA devices offer)
    int alsa_format = SND_PCM_FORMAT_FLOAT_LE;
};

inline int16_t f32_to_s16(float v) {
    float c = v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
    return (int16_t)lrintf(c * 32767.0f);
}

inline int32_t f32_to_s32(float v) {
    float c = v < -1.0f ? -1.0f : (v > 1.0f ? 1.0f : v);
    // llrint (double), NOT llrintf: the float rounding of c*2^31-1 would
    // overflow int32 at c == 1.0 (float(2147483647.0) == 2147483648.0f)
    return (int32_t)llrint((double)c * 2147483647.0);
}

uint32_t next_pow2(uint32_t v) {
    uint32_t p = 1;
    while (p < v) p <<= 1;
    return p;
}

void promote_to_rt() {
    // Audio-thread priority promotion, the analog of the reference's
    // audio_thread_priority promotion of decode/worker threads
    // (src/source/mixed/submixer/thread_pool.rs:440-449,
    // src/source/file/streamed.rs:567).  SCHED_FIFO needs CAP_SYS_NICE;
    // fall back to a negative nice value, and to nothing when sandboxed —
    // promotion is best-effort by design, exactly like the reference's
    // (which logs and continues on failure).
    sched_param sp{};
    sp.sched_priority = sched_get_priority_min(SCHED_FIFO) + 10;
    if (pthread_setschedparam(pthread_self(), SCHED_FIFO, &sp) != 0) {
        errno = 0;
        if (nice(-11) == -1 && errno != 0) { /* best-effort */ }
    }
}

void consumer_loop(Ring* r) {
    promote_to_rt();
    const uint32_t chunk = 256;  // frames per device write (~5.3 ms at 48k)
    float* scratch = (float*)std::malloc(sizeof(float) * chunk * r->channels);
    // conversion buffer for integer device formats (s32 covers s16 too)
    int32_t* conv = (int32_t*)std::malloc(sizeof(int32_t) * chunk * r->channels);
    auto next_deadline = std::chrono::steady_clock::now();
    const auto chunk_ns = std::chrono::nanoseconds(
        (int64_t)(1e9 * chunk / r->sample_rate));

    while (r->running.load(std::memory_order_acquire)) {
        if (r->paused.load(std::memory_order_acquire)) {
            std::this_thread::sleep_for(std::chrono::milliseconds(2));
            next_deadline = std::chrono::steady_clock::now();
            continue;
        }
        uint64_t rp = r->read_pos.load(std::memory_order_relaxed);
        uint64_t wp = r->write_pos.load(std::memory_order_acquire);
        uint32_t avail = (uint32_t)(wp - rp);
        uint32_t frames = avail < chunk ? avail : chunk;

        // copy out (zero-fill underruns so the device keeps running)
        for (uint32_t f = 0; f < chunk; ++f) {
            uint32_t src = (uint32_t)((rp + f) & r->mask) * r->channels;
            for (uint32_t c = 0; c < r->channels; ++c)
                scratch[f * r->channels + c] =
                    f < frames ? r->data[src + c] : 0.0f;
        }
        r->read_pos.store(rp + frames, std::memory_order_release);

        if (r->use_alsa) {
            const void* buf = scratch;
            if (r->alsa_format == SND_PCM_FORMAT_S16_LE) {
                int16_t* s16 = (int16_t*)conv;
                for (uint32_t i = 0; i < chunk * r->channels; ++i)
                    s16[i] = f32_to_s16(scratch[i]);
                buf = conv;
            } else if (r->alsa_format == SND_PCM_FORMAT_S32_LE) {
                for (uint32_t i = 0; i < chunk * r->channels; ++i)
                    conv[i] = f32_to_s32(scratch[i]);
                buf = conv;
            }
            long got = r->alsa.writei(r->pcm, buf, chunk);
            if (got < 0) r->alsa.recover(r->pcm, (int)got, 1);
        } else {
            next_deadline += chunk_ns;
            std::this_thread::sleep_until(next_deadline);
        }
    }
    std::free(scratch);
    std::free(conv);
}

}  // namespace

extern "C" {

// Negotiated device sample format (after ph_ring_create_dev):
// 14 = FLOAT_LE, 10 = S32_LE, 2 = S16_LE (ALSA snd_pcm_format_t values).
int ph_ring_format(void* handle) {
    Ring* r = (Ring*)handle;
    return r->use_alsa ? r->alsa_format : SND_PCM_FORMAT_FLOAT_LE;
}

// Sample-format conversion exports (the reference dispatches i8..f64 with
// an f32 fast path, src/output/cpal.rs:509-561).  Exposed standalone so the
// conversion path is unit-testable without sound hardware.
void ph_convert_f32_to_s16(const float* in, int16_t* out, uint32_t n) {
    for (uint32_t i = 0; i < n; ++i) out[i] = f32_to_s16(in[i]);
}

void ph_convert_f32_to_s32(const float* in, int32_t* out, uint32_t n) {
    for (uint32_t i = 0; i < n; ++i) out[i] = f32_to_s32(in[i]);
}

int ph_alsa_available() {
    AlsaApi api;
    bool ok = api.load();
    if (api.lib) dlclose(api.lib);
    return ok ? 1 : 0;
}

// Enumerate ALSA playback PCM devices (reference: cpal device listing used
// by DefaultOutputDevice).  Writes "name\tdesc\n" records into `out`;
// returns the device count, or -1 when ALSA (or the hint API) is absent.
int ph_alsa_list_devices(char* out, int cap) {
    AlsaApi api;
    if (!api.load() || !api.name_hint || !api.get_hint || !api.free_hint) {
        if (api.lib) dlclose(api.lib);
        return -1;
    }
    void** hints = nullptr;
    int count = 0;
    int used = 0;
    if (api.name_hint(-1, "pcm", &hints) == 0 && hints) {
        for (void** h = hints; *h; ++h) {
            char* ioid = api.get_hint(*h, "IOID");
            bool playback = !ioid || std::strcmp(ioid, "Output") == 0;
            if (ioid) std::free(ioid);
            if (!playback) continue;
            char* name = api.get_hint(*h, "NAME");
            if (!name) continue;
            char* desc = api.get_hint(*h, "DESC");
            // first line of the description only
            if (desc) {
                char* nl = std::strchr(desc, '\n');
                if (nl) *nl = 0;
            }
            int need = (int)std::strlen(name) + 1
                + (desc ? (int)std::strlen(desc) : 0) + 1;
            if (out && used + need < cap) {
                used += std::snprintf(out + used, cap - used, "%s\t%s\n",
                                      name, desc ? desc : "");
            }
            std::free(name);
            if (desc) std::free(desc);
            ++count;
        }
        api.free_hint(hints);
    }
    dlclose(api.lib);
    return count;
}

void* ph_ring_create_dev(uint32_t capacity_frames, uint32_t sample_rate,
                         uint32_t channels, int try_alsa, const char* device) {
    Ring* r = new Ring();
    r->capacity_frames = next_pow2(capacity_frames);
    r->mask = r->capacity_frames - 1;
    r->channels = channels;
    r->sample_rate = sample_rate;
    r->data = (float*)std::calloc((size_t)r->capacity_frames * channels,
                                  sizeof(float));
    const char* dev = (device && *device) ? device : "default";
    if (try_alsa && r->alsa.load()) {
        if (r->alsa.open_(&r->pcm, dev, SND_PCM_STREAM_PLAYBACK, 0) == 0) {
            const int formats[] = {SND_PCM_FORMAT_FLOAT_LE,
                                   SND_PCM_FORMAT_S32_LE,
                                   SND_PCM_FORMAT_S16_LE};
            for (int fmt : formats) {
                if (r->alsa.set_params(r->pcm, fmt,
                                       SND_PCM_ACCESS_RW_INTERLEAVED, channels,
                                       sample_rate, 1, 100000 /* 100 ms */) == 0) {
                    r->alsa_format = fmt;
                    r->use_alsa = true;
                    break;
                }
            }
        }
        if (!r->use_alsa && r->pcm) {
            r->alsa.close_(r->pcm);
            r->pcm = nullptr;
        }
    }
    r->consumer = std::thread(consumer_loop, r);
    return r;
}

void* ph_ring_create(uint32_t capacity_frames, uint32_t sample_rate,
                     uint32_t channels, int try_alsa) {
    return ph_ring_create_dev(capacity_frames, sample_rate, channels,
                              try_alsa, nullptr);
}

// Blocking write of interleaved f32 frames; returns frames written or -1.
int ph_ring_write(void* handle, const float* interleaved, uint32_t frames) {
    Ring* r = (Ring*)handle;
    uint32_t done = 0;
    while (done < frames && r->running.load(std::memory_order_acquire)) {
        uint64_t wp = r->write_pos.load(std::memory_order_relaxed);
        uint64_t rp = r->read_pos.load(std::memory_order_acquire);
        uint32_t space = r->capacity_frames - (uint32_t)(wp - rp);
        if (space == 0) {
            std::this_thread::sleep_for(std::chrono::milliseconds(1));
            continue;
        }
        uint32_t todo = frames - done < space ? frames - done : space;
        for (uint32_t f = 0; f < todo; ++f) {
            uint32_t dst = (uint32_t)((wp + f) & r->mask) * r->channels;
            std::memcpy(&r->data[dst], &interleaved[(done + f) * r->channels],
                        sizeof(float) * r->channels);
        }
        r->write_pos.store(wp + todo, std::memory_order_release);
        done += todo;
    }
    return (int)done;
}

uint64_t ph_ring_position(void* handle) {
    return ((Ring*)handle)->read_pos.load(std::memory_order_acquire);
}

uint32_t ph_ring_space(void* handle) {
    Ring* r = (Ring*)handle;
    uint64_t wp = r->write_pos.load(std::memory_order_relaxed);
    uint64_t rp = r->read_pos.load(std::memory_order_acquire);
    return r->capacity_frames - (uint32_t)(wp - rp);
}

void ph_ring_pause(void* handle, int paused) {
    ((Ring*)handle)->paused.store(paused != 0, std::memory_order_release);
}

int ph_ring_uses_alsa(void* handle) {
    return ((Ring*)handle)->use_alsa ? 1 : 0;
}

void ph_ring_close(void* handle) {
    Ring* r = (Ring*)handle;
    r->running.store(false, std::memory_order_release);
    if (r->consumer.joinable()) r->consumer.join();
    if (r->pcm) r->alsa.close_(r->pcm);
    if (r->alsa.lib) dlclose(r->alsa.lib);
    std::free(r->data);
    delete r;
}

}  // extern "C"
