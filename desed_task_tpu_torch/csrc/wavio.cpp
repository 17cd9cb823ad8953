// Native WAVE decoder for the host data path (counterpart of
// native/wavio.cpp, which desed_task_tpu/data/native.py builds; this copy is
// built by desed_task_tpu_torch/data/native.py).
//
// A dependency-free RIFF/WAVE parser plus a threaded batch assembler:
// decode -> mono downmix -> pad/crop runs in C++ worker threads, with the
// Python GIL released for the whole batch, so host decode overlaps the card.
// PCM 8/16/24/32-bit and 32-bit IEEE float; the parser rejects any other
// sample format (the original returns zeros for them), so the caller falls
// back to its Python reader there.
//
// C ABI (ctypes):
//   wav_info(path, *rate, *channels, *frames)            -> 0 on success
//   wav_decode(path, out, max_frames, *rate, *channels)  -> frames written
//   wav_decode_batch(paths, n, target_len, test_mode, seed, out, onsets,
//                    n_threads)
//       decodes n files in parallel into out[n, target_len] (mono, padded
//       or cropped; a crop starts at 0 in test mode, else at an onset drawn
//       by std::mt19937_64 seeded with seed + i), recording each crop's
//       onset in samples (0 when padded); returns the count of failed files.

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <cstdlib>
#include <random>
#include <thread>
#include <vector>

namespace {

struct WavData {
    int rate = 0;
    int channels = 0;
    long frames = 0;
    int format = 0;  // 1 = PCM, 3 = float
    int bits = 0;
    const uint8_t* data = nullptr;  // points into the file buffer
    size_t data_len = 0;
};

bool parse_header(const uint8_t* buf, size_t len, WavData* w) {
    if (len < 44 || memcmp(buf, "RIFF", 4) != 0 || memcmp(buf + 8, "WAVE", 4) != 0)
        return false;
    size_t pos = 12;
    bool have_fmt = false, have_data = false;
    while (pos + 8 <= len) {
        const uint8_t* cid = buf + pos;
        uint32_t size;
        memcpy(&size, buf + pos + 4, 4);
        const uint8_t* body = buf + pos + 8;
        if (pos + 8 + size > len) size = (uint32_t)(len - pos - 8);
        if (memcmp(cid, "fmt ", 4) == 0 && size >= 16) {
            uint16_t fmt, ch, block, bits;
            uint32_t rate;
            memcpy(&fmt, body, 2);
            memcpy(&ch, body + 2, 2);
            memcpy(&rate, body + 4, 4);
            memcpy(&block, body + 12, 2);
            memcpy(&bits, body + 14, 2);
            if (fmt == 0xFFFE) fmt = (bits == 32 && block == 4 * ch) ? 3 : 1;
            w->format = fmt;
            w->channels = ch;
            w->rate = (int)rate;
            w->bits = bits;
            have_fmt = true;
        } else if (memcmp(cid, "data", 4) == 0) {
            w->data = body;
            w->data_len = size;
            have_data = true;
        }
        pos += 8 + size + (size & 1);
    }
    if (!have_fmt || !have_data || w->channels <= 0 || w->bits <= 0) return false;
    const bool decodable = (w->format == 3 && w->bits == 32) ||
        (w->format == 1 && (w->bits == 8 || w->bits == 16 || w->bits == 24 || w->bits == 32));
    if (!decodable) return false;
    w->frames = (long)(w->data_len / (w->channels * (w->bits / 8)));
    return true;
}

// decode interleaved samples -> mono float32 (mean over channels)
void decode_mono(const WavData& w, float* out, long max_frames) {
    const long n = w.frames < max_frames ? w.frames : max_frames;
    const int ch = w.channels;
    const double inv_ch = 1.0 / ch;
    if (w.format == 3 && w.bits == 32) {
        const float* src = reinterpret_cast<const float*>(w.data);
        for (long i = 0; i < n; i++) {
            double acc = 0;
            for (int c = 0; c < ch; c++) acc += src[i * ch + c];
            out[i] = (float)(acc * inv_ch);
        }
    } else if (w.format == 1 && w.bits == 16) {
        const int16_t* src = reinterpret_cast<const int16_t*>(w.data);
        const double scale = inv_ch / 32768.0;
        for (long i = 0; i < n; i++) {
            double acc = 0;
            for (int c = 0; c < ch; c++) acc += src[i * ch + c];
            out[i] = (float)(acc * scale);
        }
    } else if (w.format == 1 && w.bits == 32) {
        const int32_t* src = reinterpret_cast<const int32_t*>(w.data);
        const double scale = inv_ch / 2147483648.0;
        for (long i = 0; i < n; i++) {
            double acc = 0;
            for (int c = 0; c < ch; c++) acc += (double)src[i * ch + c];
            out[i] = (float)(acc * scale);
        }
    } else if (w.format == 1 && w.bits == 24) {
        const uint8_t* src = w.data;
        const double scale = inv_ch / 8388608.0;
        for (long i = 0; i < n; i++) {
            double acc = 0;
            for (int c = 0; c < ch; c++) {
                const uint8_t* p = src + 3 * (i * ch + c);
                int32_t v = (int32_t)(p[0] | (p[1] << 8) | (p[2] << 16));
                if (v >= (1 << 23)) v -= (1 << 24);
                acc += (double)v;
            }
            out[i] = (float)(acc * scale);
        }
    } else if (w.format == 1 && w.bits == 8) {
        const uint8_t* src = w.data;
        const double scale = inv_ch / 128.0;
        for (long i = 0; i < n; i++) {
            double acc = 0;
            for (int c = 0; c < ch; c++) acc += (double)src[i * ch + c] - 128.0;
            out[i] = (float)(acc * scale);
        }
    }
}

std::vector<uint8_t> read_file(const char* path) {
    std::vector<uint8_t> buf;
    FILE* f = fopen(path, "rb");
    if (!f) return buf;
    fseek(f, 0, SEEK_END);
    long size = ftell(f);
    fseek(f, 0, SEEK_SET);
    if (size > 0) {
        buf.resize((size_t)size);
        if (fread(buf.data(), 1, (size_t)size, f) != (size_t)size) buf.clear();
    }
    fclose(f);
    return buf;
}

}  // namespace

extern "C" {

int wav_info(const char* path, int* rate, int* channels, long* frames) {
    auto buf = read_file(path);
    WavData w;
    if (buf.empty() || !parse_header(buf.data(), buf.size(), &w)) return -1;
    *rate = w.rate;
    *channels = w.channels;
    *frames = w.frames;
    return 0;
}

long wav_decode(const char* path, float* out, long max_frames, int* rate,
                int* channels) {
    auto buf = read_file(path);
    WavData w;
    if (buf.empty() || !parse_header(buf.data(), buf.size(), &w)) return -1;
    *rate = w.rate;
    *channels = w.channels;
    long n = w.frames < max_frames ? w.frames : max_frames;
    decode_mono(w, out, max_frames);
    return n;
}

// Parallel batch load: out is [n_files, target_len] float32 (caller-owned).
// onsets[i] receives the crop start in samples (0 when padded).
// Returns 0 on success, else the count of failed files.
int wav_decode_batch(const char** paths, int n_files, long target_len,
                     int test_mode, uint64_t seed, float* out, long* onsets,
                     int n_threads) {
    if (n_threads <= 0) {
        n_threads = (int)std::thread::hardware_concurrency();
        if (n_threads <= 0) n_threads = 4;
    }
    if (n_threads > n_files) n_threads = n_files;
    std::vector<int> failures(n_threads, 0);
    auto worker = [&](int tid) {
        for (int i = tid; i < n_files; i += n_threads) {
            float* dst = out + (size_t)i * target_len;
            auto buf = read_file(paths[i]);
            WavData w;
            if (buf.empty() || !parse_header(buf.data(), buf.size(), &w)) {
                memset(dst, 0, sizeof(float) * (size_t)target_len);
                onsets[i] = 0;
                failures[tid]++;
                continue;
            }
            if (w.frames <= target_len) {
                decode_mono(w, dst, target_len);
                if (w.frames < target_len)
                    memset(dst + w.frames, 0,
                           sizeof(float) * (size_t)(target_len - w.frames));
                onsets[i] = 0;
            } else {
                long start = 0;
                if (!test_mode) {
                    std::mt19937_64 rng(seed + (uint64_t)i);
                    std::uniform_int_distribution<long> dist(
                        0, w.frames - target_len);
                    start = dist(rng);
                }
                // shift the data pointer by start frames and decode
                WavData ww = w;
                ww.data = w.data + (size_t)start * w.channels * (w.bits / 8);
                ww.data_len = w.data_len - (size_t)start * w.channels * (w.bits / 8);
                ww.frames = w.frames - start;
                decode_mono(ww, dst, target_len);
                onsets[i] = start;
            }
        }
    };
    std::vector<std::thread> threads;
    for (int t = 0; t < n_threads; t++) threads.emplace_back(worker, t);
    for (auto& t : threads) t.join();
    int total = 0;
    for (int f : failures) total += f;
    return total;
}

}  // extern "C"
