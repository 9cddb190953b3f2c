// Native WAV decoding for the streaming audio loader.
//
// A copy of diart_tpu/native/wavio.cpp. diart delegates decoding to
// torchaudio's C++ backends (its audio.py). This is the equivalent native
// tier: a dependency-free RIFF/WAVE reader that decodes PCM
// 8/16/24/32-bit and IEEE float to mono float32 in one pass, exposed to
// Python via ctypes (see diart_tpu_torch/native/__init__.py). Benchmark-scale
// corpora decode ~20x faster than the pure-numpy fallback path.
//
// Build: cc -O3 -shared -fPIC wavio.cpp -o libwavio.so

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <vector>

namespace {

struct FmtChunk {
  uint16_t format = 0;
  uint16_t channels = 0;
  uint32_t sample_rate = 0;
  uint16_t bits = 0;
  // WAVE_FORMAT_EXTENSIBLE SubFormat code (first 2 bytes of the GUID:
  // 1 = PCM, 3 = float); 0 when the chunk carries no extension
  uint16_t sub_format = 0;
};

// Reads chunks until "data"; fills fmt and positions the file at the start
// of sample data. Returns data byte size, or -1 on malformed input.
long find_data(FILE* f, FmtChunk* fmt) {
  char magic[5] = {0};
  uint32_t size = 0;
  char wave[5] = {0};
  if (fread(magic, 1, 4, f) != 4 || memcmp(magic, "RIFF", 4) != 0) return -1;
  if (fread(&size, 4, 1, f) != 1) return -1;
  if (fread(wave, 1, 4, f) != 4 || memcmp(wave, "WAVE", 4) != 0) return -1;
  while (true) {
    char id[5] = {0};
    uint32_t chunk_size = 0;
    if (fread(id, 1, 4, f) != 4 || fread(&chunk_size, 4, 1, f) != 1) return -1;
    if (memcmp(id, "fmt ", 4) == 0) {
      uint8_t buf[40] = {0};
      uint32_t take = chunk_size < 40 ? chunk_size : 40;
      if (chunk_size < 16 || fread(buf, 1, take, f) != take) return -1;
      memcpy(&fmt->format, buf + 0, 2);
      memcpy(&fmt->channels, buf + 2, 2);
      memcpy(&fmt->sample_rate, buf + 4, 4);
      memcpy(&fmt->bits, buf + 14, 2);
      if (fmt->format == 0xFFFE && take >= 26) {
        memcpy(&fmt->sub_format, buf + 24, 2);
      }
      long rest = (long)chunk_size - (long)take + (long)(chunk_size & 1);
      if (rest > 0) fseek(f, rest, SEEK_CUR);
    } else if (memcmp(id, "data", 4) == 0) {
      // clamp placeholder/oversized data sizes (streamed WAVs write 0 or
      // 0xFFFFFFFF) to the bytes actually present in the file
      long pos = ftell(f);
      fseek(f, 0, SEEK_END);
      long avail = ftell(f) - pos;
      fseek(f, pos, SEEK_SET);
      if (avail < 0) avail = 0;
      if (chunk_size == 0 || chunk_size == 0xFFFFFFFFu ||
          (long)chunk_size > avail) {
        return avail;
      }
      return (long)chunk_size;
    } else {
      fseek(f, chunk_size + (chunk_size & 1), SEEK_CUR);
    }
  }
}

bool is_float_fmt(const FmtChunk& fmt) {
  if (fmt.format == 0xFFFE) {
    // the SubFormat GUID disambiguates 32-bit int PCM from float; fall
    // back to the 32-bit-means-float heuristic only when absent
    if (fmt.sub_format != 0) return fmt.sub_format == 3;
    return fmt.bits == 32;
  }
  return fmt.format == 3;
}

// Guards against malformed headers: bits must be a whole number of bytes we
// know how to decode (a bits value in 1..7 would make bytes-per-sample 0 and
// divide by zero below), and IEEE-float data must be 32-bit (the decode loop
// memcpy's 4 bytes per float sample).
bool fmt_is_valid(const FmtChunk& fmt) {
  if (fmt.channels == 0) return false;
  if (fmt.bits != 8 && fmt.bits != 16 && fmt.bits != 24 && fmt.bits != 32)
    return false;
  if (is_float_fmt(fmt) && fmt.bits != 32) return false;
  return true;
}

}  // namespace

extern "C" {

// Probe sample rate / frame count / channels. Returns 0 on success.
int wav_probe(const char* path, int* sample_rate, long* num_frames,
              int* channels) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  FmtChunk fmt;
  long data_size = find_data(f, &fmt);
  fclose(f);
  if (data_size < 0 || !fmt_is_valid(fmt)) return -2;
  *sample_rate = (int)fmt.sample_rate;
  *channels = (int)fmt.channels;
  *num_frames = data_size / (fmt.channels * (fmt.bits / 8));
  return 0;
}

// Decode to mono float32 (mean over channels). `out` must hold at least
// `max_frames` floats. Returns frames written, or < 0 on error.
long wav_decode_mono_f32(const char* path, float* out, long max_frames) {
  FILE* f = fopen(path, "rb");
  if (!f) return -1;
  FmtChunk fmt;
  long data_size = find_data(f, &fmt);
  if (data_size < 0 || !fmt_is_valid(fmt)) {
    fclose(f);
    return -2;
  }
  const int ch = fmt.channels;
  const int bytes_per = fmt.bits / 8;
  const long frames = data_size / (ch * bytes_per);
  const long n = frames < max_frames ? frames : max_frames;

  std::vector<uint8_t> raw((size_t)n * ch * bytes_per);
  size_t got = fread(raw.data(), 1, raw.size(), f);
  fclose(f);
  const long usable = (long)(got / (ch * bytes_per));

  const bool is_float = is_float_fmt(fmt);
  const float inv_ch = 1.0f / ch;
  for (long i = 0; i < usable; ++i) {
    float acc = 0.0f;
    for (int c = 0; c < ch; ++c) {
      const uint8_t* p = raw.data() + ((size_t)i * ch + c) * bytes_per;
      float v = 0.0f;
      if (is_float) {
        float tmp;
        memcpy(&tmp, p, 4);
        v = tmp;
      } else if (fmt.bits == 16) {
        int16_t s;
        memcpy(&s, p, 2);
        v = (float)s / 32768.0f;
      } else if (fmt.bits == 32) {
        int32_t s;
        memcpy(&s, p, 4);
        v = (float)s / 2147483648.0f;
      } else if (fmt.bits == 24) {
        int32_t s = (int32_t)(p[0] | (p[1] << 8) | (p[2] << 16));
        if (s >= (1 << 23)) s -= (1 << 24);
        v = (float)s / 8388608.0f;
      } else if (fmt.bits == 8) {
        v = ((float)p[0] - 128.0f) / 128.0f;
      }
      acc += v;
    }
    out[i] = acc * inv_ch;
  }
  return usable;
}

}  // extern "C"
