// Native threaded scene loader of the REGNet PyTorch port: a copy of the
// JAX package's native/loader.cc, built by data/native_loader.py.
//
// The reference feeds training through torch's DataLoader (8 worker
// subprocesses doing pickle parsing + numpy resampling, utils.py:41-57).
// Here the equivalent runtime component is a C++ thread pool over a flat
// binary scene cache (.rsc files, written by data/native_loader.py):
// per-item it resamples the cloud to a fixed point budget, applies the
// per-class color jitter (scoredataset.py:52-58), tanh-squashes scores and
// pads the GT grasp arrays — then double-buffers whole batches so the next
// batch is ready while the device steps.
//
// Exposed as a C ABI for ctypes (no pybind11 in this image).
//
// .rsc layout (all little-endian):
//   char[4]  "RSC1"
//   int32    n_points
//   int32    n_grasps
//   f32[n_points*3]  view_xyz
//   f32[n_points*3]  color
//   f32[n_points]    score          (raw, pre-tanh)
//   f32[n_points]    label          (0 = table)
//   f32[n_grasps*12] frames         (3x4 row-major)
//   f32[n_grasps*3]  grasp_scores   (score, antipodal, center)

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <cmath>
#include <condition_variable>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <mutex>
#include <random>
#include <string>
#include <thread>
#include <vector>

namespace {

struct Scene {
  std::vector<float> xyz, color, score, label, frames, gscores;
  int32_t n_points = 0, n_grasps = 0;
  bool ok = false;
};

// Zero-copy view of one scene, either into an mmap'd .rsc (preferred:
// each scene is mapped once and stays page-cached across epochs, instead
// of a ~1MB fread per batch item) or into a fallback heap Scene.
struct SceneView {
  const float *xyz = nullptr, *color = nullptr, *score = nullptr,
              *label = nullptr, *frames = nullptr, *gscores = nullptr;
  int32_t n_points = 0, n_grasps = 0;
  bool ok = false;
};

struct Mapping {
  void* base = nullptr;
  size_t len = 0;
  SceneView view;
  bool tried = false;
};

SceneView view_of(const Scene& s) {
  SceneView v;
  v.xyz = s.xyz.data();
  v.color = s.color.data();
  v.score = s.score.data();
  v.label = s.label.data();
  v.frames = s.frames.data();
  v.gscores = s.gscores.data();
  v.n_points = s.n_points;
  v.n_grasps = s.n_grasps;
  v.ok = s.ok;
  return v;
}

Mapping map_scene(const std::string& path) {
  Mapping m;
  m.tried = true;
  int fd = open(path.c_str(), O_RDONLY);
  if (fd < 0) return m;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size < 12) {
    close(fd);
    return m;
  }
  void* base = mmap(nullptr, st.st_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (base == MAP_FAILED) return m;
  const char* p = static_cast<const char*>(base);
  int32_t np = 0, ng = 0;
  std::memcpy(&np, p + 4, 4);
  std::memcpy(&ng, p + 8, 4);
  size_t need =
      12 + 4 * ((size_t)np * 3 * 2 + (size_t)np * 2 + (size_t)ng * 15);
  if (std::memcmp(p, "RSC1", 4) || np <= 0 || ng < 0 ||
      (size_t)st.st_size < need) {
    munmap(base, st.st_size);
    return m;
  }
  m.base = base;
  m.len = st.st_size;
  madvise(base, st.st_size, MADV_WILLNEED);
  const float* f = reinterpret_cast<const float*>(p + 12);
  SceneView& v = m.view;
  v.xyz = f;
  v.color = v.xyz + (size_t)np * 3;
  v.score = v.color + (size_t)np * 3;
  v.label = v.score + np;
  v.frames = v.label + np;
  v.gscores = v.frames + (size_t)ng * 12;
  v.n_points = np;
  v.n_grasps = ng;
  v.ok = true;
  return m;
}

Scene load_scene(const std::string& path) {
  Scene s;
  FILE* f = std::fopen(path.c_str(), "rb");
  if (!f) return s;
  char magic[4];
  if (std::fread(magic, 1, 4, f) != 4 || std::memcmp(magic, "RSC1", 4)) {
    std::fclose(f);
    return s;
  }
  int32_t np = 0, ng = 0;
  if (std::fread(&np, 4, 1, f) != 1 || std::fread(&ng, 4, 1, f) != 1 ||
      np <= 0 || ng < 0) {
    std::fclose(f);
    return s;
  }
  s.n_points = np;
  s.n_grasps = ng;
  auto rd = [&](std::vector<float>& v, size_t n) {
    v.resize(n);
    return std::fread(v.data(), 4, n, f) == n;
  };
  bool ok = rd(s.xyz, (size_t)np * 3) && rd(s.color, (size_t)np * 3) &&
            rd(s.score, np) && rd(s.label, np) &&
            rd(s.frames, (size_t)ng * 12) && rd(s.gscores, (size_t)ng * 3);
  std::fclose(f);
  s.ok = ok;
  return s;
}

struct Batch {
  std::vector<float> pc;       // [B, N, 6]
  std::vector<float> score;    // [B, N]
  std::vector<float> label;    // [B, N]
  std::vector<float> frames;   // [B, MG, 12]
  std::vector<float> gscores;  // [B, MG, 3]
  std::vector<uint8_t> valid;  // [B, MG]
  std::vector<int32_t> ids;    // [B] scene indices
};

struct Loader {
  std::vector<std::string> paths;
  int num_points, max_grasps, batch_size, n_threads;
  bool augment;
  uint64_t seed;

  std::vector<int> order;
  size_t cursor = 0;
  uint64_t epoch = 0;

  Batch ready, filling;
  std::thread prefetcher;
  std::mutex mu;
  std::condition_variable cv;
  bool ready_ok = false, stop = false;

  std::vector<Mapping> maps;   // lazily mmap'd scenes (index == paths)
  std::mutex map_mu;

  // Map-once accessor; returns an invalid view when mmap fails (the
  // caller then falls back to the fread path).
  const SceneView& view(int i) {
    std::lock_guard<std::mutex> lk(map_mu);
    if (!maps[i].tried) maps[i] = map_scene(paths[i]);
    return maps[i].view;
  }

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stop = true;
    }
    cv.notify_all();
    if (prefetcher.joinable()) prefetcher.join();
    for (auto& m : maps)
      if (m.base) munmap(m.base, m.len);
  }
};

uint64_t splitmix(uint64_t& x) {
  x += 0x9e3779b97f4a7c15ull;
  uint64_t z = x;
  z = (z ^ (z >> 30)) * 0xbf58476d1ce4e5b9ull;
  z = (z ^ (z >> 27)) * 0x94d049bb133111ebull;
  return z ^ (z >> 31);
}

float uniformf(uint64_t& state) {
  return (splitmix(state) >> 40) * (1.0f / (1ull << 24));
}

void fill_item(Loader* L, Batch& b, int slot, int scene_idx,
               uint64_t rng_seed) {
  SceneView s = L->view(scene_idx);
  Scene fallback;
  if (!s.ok) {
    fallback = load_scene(L->paths[scene_idx]);
    s = view_of(fallback);
  }
  const int N = L->num_points, MG = L->max_grasps;
  float* pc = b.pc.data() + (size_t)slot * N * 6;
  float* sc = b.score.data() + (size_t)slot * N;
  float* lb = b.label.data() + (size_t)slot * N;
  float* fr = b.frames.data() + (size_t)slot * MG * 12;
  float* gs = b.gscores.data() + (size_t)slot * MG * 3;
  uint8_t* va = b.valid.data() + (size_t)slot * MG;
  b.ids[slot] = scene_idx;
  std::memset(fr, 0, sizeof(float) * MG * 12);
  std::memset(gs, 0, sizeof(float) * MG * 3);
  std::memset(va, 0, MG);
  if (!s.ok) {
    std::memset(pc, 0, sizeof(float) * (size_t)N * 6);
    std::memset(sc, 0, sizeof(float) * N);
    std::memset(lb, 0, sizeof(float) * N);
    return;
  }

  uint64_t st = rng_seed;
  // per-class color jitter factors (scoredataset.py:52-58)
  float table_t[3], obj_t[3];
  for (int c = 0; c < 3; ++c) table_t[c] = uniformf(st);
  for (int c = 0; c < 3; ++c) obj_t[c] = 1.0f - uniformf(st) / 5.0f;
  // scene-level photometric augmentation (dataset.py _global_color_aug:
  // per-channel gain, gamma, brightness offset — same distributions,
  // independent RNG stream)
  float gain[3];
  for (int c = 0; c < 3; ++c) gain[c] = 0.7f + 0.6f * uniformf(st);
  float gamma = 0.7f + 0.7f * uniformf(st);
  float offset = -0.25f + 0.55f * uniformf(st);
  if (!L->augment) {
    for (int c = 0; c < 3; ++c) table_t[c] = obj_t[c] = gain[c] = 1.0f;
    gamma = 1.0f;
    offset = 0.0f;
  }

  const bool replace = s.n_points < N;
  // without-replacement resample via partial Fisher-Yates when possible
  std::vector<int32_t> pick(N);
  if (!replace) {
    std::vector<int32_t> idx(s.n_points);
    for (int i = 0; i < s.n_points; ++i) idx[i] = i;
    for (int i = 0; i < N; ++i) {
      int j = i + (int)(splitmix(st) % (uint64_t)(s.n_points - i));
      std::swap(idx[i], idx[j]);
      pick[i] = idx[i];
    }
  } else {
    for (int i = 0; i < N; ++i)
      pick[i] = (int32_t)(splitmix(st) % (uint64_t)s.n_points);
  }

  for (int i = 0; i < N; ++i) {
    const int p = pick[i];
    const float* x = &s.xyz[(size_t)p * 3];
    const float* c = &s.color[(size_t)p * 3];
    const float lab = s.label[p];
    const float* t = (lab == 0.0f) ? table_t : obj_t;
    float* out = pc + (size_t)i * 6;
    out[0] = x[0];
    out[1] = x[1];
    out[2] = x[2];
    for (int ch = 0; ch < 3; ++ch) {
      float v = c[ch] * t[ch] * gain[ch];
      v = std::min(std::max(v, 0.0f), 1.0f);
      v = std::pow(v, gamma) + offset;
      out[3 + ch] = std::min(std::max(v, 0.0f), 1.0f);
    }
    sc[i] = std::tanh(s.score[p]);
    lb[i] = lab;
  }

  const int g = std::min(s.n_grasps, MG);
  std::memcpy(fr, s.frames, sizeof(float) * (size_t)g * 12);
  std::memcpy(gs, s.gscores, sizeof(float) * (size_t)g * 3);
  std::memset(va, 1, g);
}

void fill_batch(Loader* L, Batch& b) {
  const int B = L->batch_size;
  if (L->cursor + B > L->order.size()) {
    // new epoch: reshuffle
    L->epoch++;
    uint64_t st = L->seed + L->epoch * 0x517cc1b727220a95ull;
    for (size_t i = L->order.size(); i > 1; --i) {
      size_t j = splitmix(st) % i;
      std::swap(L->order[i - 1], L->order[j]);
    }
    L->cursor = 0;
  }
  std::vector<std::thread> workers;
  int per = (B + L->n_threads - 1) / L->n_threads;
  for (int t = 0; t < L->n_threads; ++t) {
    int lo = t * per, hi = std::min(B, lo + per);
    if (lo >= hi) break;
    workers.emplace_back([=, &b]() {
      for (int i = lo; i < hi; ++i) {
        int scene = L->order[(L->cursor + i) % L->order.size()];
        uint64_t item_seed =
            L->seed ^ (L->epoch * 1000003ull + L->cursor + i) * 0x2545F4914F6CDD1Dull;
        fill_item(L, b, i, scene, item_seed);
      }
    });
  }
  for (auto& w : workers) w.join();
  L->cursor += B;
}

void prefetch_loop(Loader* L) {
  for (;;) {
    fill_batch(L, L->filling);
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv.wait(lk, [L] { return !L->ready_ok || L->stop; });
    if (L->stop) return;
    std::swap(L->ready, L->filling);
    L->ready_ok = true;
    L->cv.notify_all();
  }
}

}  // namespace

extern "C" {

void* rsc_loader_create(const char** paths, int n_paths, int batch_size,
                        int num_points, int max_grasps, uint64_t seed,
                        int n_threads, int augment) {
  auto* L = new Loader();
  for (int i = 0; i < n_paths; ++i) L->paths.emplace_back(paths[i]);
  L->batch_size = batch_size;
  L->num_points = num_points;
  L->max_grasps = max_grasps;
  L->seed = seed;
  L->n_threads = std::max(1, n_threads);
  L->augment = augment != 0;
  L->order.resize(L->paths.size());
  for (size_t i = 0; i < L->paths.size(); ++i) L->order[i] = (int)i;
  L->cursor = L->order.size();  // trigger shuffle on first batch

  auto alloc = [&](Batch& b) {
    b.pc.resize((size_t)batch_size * num_points * 6);
    b.score.resize((size_t)batch_size * num_points);
    b.label.resize((size_t)batch_size * num_points);
    b.frames.resize((size_t)batch_size * max_grasps * 12);
    b.gscores.resize((size_t)batch_size * max_grasps * 3);
    b.valid.resize((size_t)batch_size * max_grasps);
    b.ids.resize(batch_size);
  };
  alloc(L->ready);
  alloc(L->filling);
  L->maps.resize(L->paths.size());
  L->prefetcher = std::thread(prefetch_loop, L);
  return L;
}

// Blocks until the prefetched batch is ready, copies it out, and kicks off
// the next prefetch.  Returns 0 on success.
int rsc_loader_next(void* handle, float* pc, float* score, float* label,
                    float* frames, float* gscores, uint8_t* valid,
                    int32_t* ids) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  L->cv.wait(lk, [L] { return L->ready_ok || L->stop; });
  if (L->stop) return 1;
  Batch& b = L->ready;
  std::memcpy(pc, b.pc.data(), b.pc.size() * 4);
  std::memcpy(score, b.score.data(), b.score.size() * 4);
  std::memcpy(label, b.label.data(), b.label.size() * 4);
  std::memcpy(frames, b.frames.data(), b.frames.size() * 4);
  std::memcpy(gscores, b.gscores.data(), b.gscores.size() * 4);
  std::memcpy(valid, b.valid.data(), b.valid.size());
  std::memcpy(ids, b.ids.data(), b.ids.size() * 4);
  L->ready_ok = false;
  lk.unlock();
  L->cv.notify_all();
  return 0;
}

void rsc_loader_destroy(void* handle) {
  delete static_cast<Loader*>(handle);
}

}  // extern "C"
