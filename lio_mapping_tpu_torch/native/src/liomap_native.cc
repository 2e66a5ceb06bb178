// liomap_native: host-side runtime of the LIO engine (the PyTorch port's
// copy of lio_mapping_tpu/native/src/liomap_native.cc; the files it writes
// are byte-identical to the reference's).
//
// One change against the reference: the last sweep read (points, ring
// channel, has-ring flag) lives in the log handle, not in thread_local
// globals, so two logs read in turns in one thread keep their own sweeps.
//
// The reference delegates its runtime to ROS + PCL (rosbag replay,
// TCPROS transport, KdTree/VoxelGrid on the host). Here the host-side
// runtime is a small dependency-free C++17 library exposed through a C ABI
// (loaded via ctypes):
//
//  1. sequence log reader/writer  — the rosbag replacement: a simple
//     binary container of timestamped LiDAR sweeps + IMU samples
//     (reference counterpart: bag replay in README.md:31-36 and
//     save_bag_to_pcd.cc).
//  2. global voxel-hash map store — unbounded host-side map archive with
//     running per-voxel centroids (reference counterpart: the accumulated
//     map published from PointMapping/MapBuilder for rviz + PCD export).
//  3. measurement queue           — timestamp pairing of IMU streams with
//     sweeps (reference counterpart: MeasurementManager.cc:54-108,
//     including the msg_time_delay pairing rule and the one-sample
//     lookahead for interpolation).
//
// Everything is single-writer/single-reader and lock-free on the hot path;
// the device compute path never blocks on this code.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <deque>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

extern "C" {

// ===========================================================================
// 1. Sequence log (binary container)
//
// layout: magic "LIOL" | u32 version | frames...
// v1 frame: u8 tag ('S' sweep | 'I' imu) |
//   sweep: f64 t | u32 n | n * (3 f32 xyz + f32 rel_time_hint)
//   imu:   f64 t | 3 f32 acc | 3 f32 gyr
// v2 sweep frame adds an optional per-point ring channel (the reference's
// PointXYZIR annotation for unevenly-spaced lasers, sensor_type 320 —
// point_types.h:37-44, processor_node.cc:68-74):
//   f64 t | u32 n | u8 flags (bit0 = has_ring) |
//   n * (3 f32 xyz + f32 rel_time_hint) | [n * u16 ring]
// Writers emit v2; readers accept both.
// ===========================================================================

struct LioLog {
  FILE* f = nullptr;
  bool writing = false;
  uint32_t version = 2;
  // the payload of the last sweep lio_log_next read from this handle
  std::vector<float> sweep_buf;
  std::vector<uint16_t> ring_buf;
  bool has_ring = false;
};

void* lio_log_open(const char* path, int write) {
  auto* log = new LioLog();
  log->writing = write != 0;
  log->f = std::fopen(path, write ? "wb" : "rb");
  if (!log->f) {
    delete log;
    return nullptr;
  }
  if (write) {
    std::fwrite("LIOL", 1, 4, log->f);
    uint32_t version = 2;
    log->version = version;
    std::fwrite(&version, sizeof(version), 1, log->f);
  } else {
    char magic[4];
    uint32_t version = 0;
    if (std::fread(magic, 1, 4, log->f) != 4 || std::memcmp(magic, "LIOL", 4) != 0 ||
        std::fread(&version, sizeof(version), 1, log->f) != 1 || version < 1 ||
        version > 2) {
      std::fclose(log->f);
      delete log;
      return nullptr;
    }
    log->version = version;
  }
  return log;
}

// ring: per-point u16 ring annotation, or null for none (v2 flag bit 0).
int lio_log_write_sweep2(void* handle, double t, const float* xyzr,
                         const uint16_t* ring, uint32_t n) {
  auto* log = static_cast<LioLog*>(handle);
  uint8_t tag = 'S';
  std::fwrite(&tag, 1, 1, log->f);
  std::fwrite(&t, sizeof(t), 1, log->f);
  std::fwrite(&n, sizeof(n), 1, log->f);
  uint8_t flags = ring ? 1 : 0;
  std::fwrite(&flags, 1, 1, log->f);
  std::fwrite(xyzr, sizeof(float) * 4, n, log->f);
  if (ring) std::fwrite(ring, sizeof(uint16_t), n, log->f);
  return 0;
}

int lio_log_write_sweep(void* handle, double t, const float* xyzr, uint32_t n) {
  return lio_log_write_sweep2(handle, t, xyzr, nullptr, n);
}

int lio_log_write_imu(void* handle, double t, const float* acc, const float* gyr) {
  auto* log = static_cast<LioLog*>(handle);
  uint8_t tag = 'I';
  std::fwrite(&tag, 1, 1, log->f);
  std::fwrite(&t, sizeof(t), 1, log->f);
  std::fwrite(acc, sizeof(float), 3, log->f);
  std::fwrite(gyr, sizeof(float), 3, log->f);
  return 0;
}

// Returns tag ('S'/'I'), 0 on EOF, -1 on error. For sweeps, *n_out is the
// point count; call lio_log_read_sweep_data (and, if lio_log_sweep_has_ring,
// lio_log_read_sweep_ring) to fetch the payload, which stays in the handle
// until its next lio_log_next.
int lio_log_next(void* handle, double* t_out, uint32_t* n_out, float* acc_out,
                 float* gyr_out) {
  auto* log = static_cast<LioLog*>(handle);
  uint8_t tag;
  if (std::fread(&tag, 1, 1, log->f) != 1) return 0;
  if (std::fread(t_out, sizeof(double), 1, log->f) != 1) return -1;
  if (tag == 'S') {
    if (std::fread(n_out, sizeof(uint32_t), 1, log->f) != 1) return -1;
    uint8_t flags = 0;
    if (log->version >= 2 && std::fread(&flags, 1, 1, log->f) != 1) return -1;
    log->sweep_buf.resize(size_t(*n_out) * 4);
    if (std::fread(log->sweep_buf.data(), sizeof(float) * 4, *n_out, log->f) != *n_out)
      return -1;
    log->has_ring = (flags & 1) != 0;
    if (log->has_ring) {
      log->ring_buf.resize(*n_out);
      if (std::fread(log->ring_buf.data(), sizeof(uint16_t), *n_out, log->f) != *n_out)
        return -1;
    }
    return 'S';
  }
  if (tag == 'I') {
    if (std::fread(acc_out, sizeof(float), 3, log->f) != 3) return -1;
    if (std::fread(gyr_out, sizeof(float), 3, log->f) != 3) return -1;
    return 'I';
  }
  return -1;
}

int lio_log_read_sweep_data(void* handle, float* out, uint32_t n) {
  const auto* log = static_cast<const LioLog*>(handle);
  if (log->sweep_buf.size() < size_t(n) * 4) return -1;
  std::memcpy(out, log->sweep_buf.data(), sizeof(float) * 4 * n);
  return 0;
}

int lio_log_sweep_has_ring(void* handle) {
  return static_cast<const LioLog*>(handle)->has_ring ? 1 : 0;
}

int lio_log_read_sweep_ring(void* handle, uint16_t* out, uint32_t n) {
  const auto* log = static_cast<const LioLog*>(handle);
  if (!log->has_ring || log->ring_buf.size() < n) return -1;
  std::memcpy(out, log->ring_buf.data(), sizeof(uint16_t) * n);
  return 0;
}

void lio_log_close(void* handle) {
  auto* log = static_cast<LioLog*>(handle);
  if (log->f) std::fclose(log->f);
  delete log;
}

// ===========================================================================
// 2. Global voxel-hash map store (running centroids per voxel)
// ===========================================================================

struct VoxelCell {
  double sx = 0, sy = 0, sz = 0;
  uint32_t count = 0;
};

struct VoxelKeyHash {
  size_t operator()(int64_t k) const {
    // splitmix64
    uint64_t x = static_cast<uint64_t>(k);
    x += 0x9e3779b97f4a7c15ull;
    x = (x ^ (x >> 30)) * 0xbf58476d1ce4e5b9ull;
    x = (x ^ (x >> 27)) * 0x94d049bb133111ebull;
    return static_cast<size_t>(x ^ (x >> 31));
  }
};

struct VoxelMap {
  double leaf = 0.4;
  std::unordered_map<int64_t, VoxelCell, VoxelKeyHash> cells;
};

void* lio_map_create(double leaf) {
  auto* m = new VoxelMap();
  m->leaf = leaf;
  m->cells.reserve(1 << 20);
  return m;
}

static inline int64_t voxel_key(const VoxelMap* m, float x, float y, float z) {
  const int64_t vx = static_cast<int64_t>(std::floor(x / m->leaf)) + (1 << 20);
  const int64_t vy = static_cast<int64_t>(std::floor(y / m->leaf)) + (1 << 20);
  const int64_t vz = static_cast<int64_t>(std::floor(z / m->leaf)) + (1 << 20);
  return (vx << 42) | (vy << 21) | vz;
}

void lio_map_insert(void* handle, const float* xyz, uint32_t n) {
  auto* m = static_cast<VoxelMap*>(handle);
  for (uint32_t i = 0; i < n; ++i) {
    const float x = xyz[3 * i], y = xyz[3 * i + 1], z = xyz[3 * i + 2];
    VoxelCell& c = m->cells[voxel_key(m, x, y, z)];
    c.sx += x;
    c.sy += y;
    c.sz += z;
    c.count += 1;
  }
}

uint64_t lio_map_size(void* handle) {
  return static_cast<VoxelMap*>(handle)->cells.size();
}

// Fills up to cap centroids; returns the number written.
uint64_t lio_map_extract(void* handle, float* out, uint64_t cap) {
  auto* m = static_cast<VoxelMap*>(handle);
  uint64_t k = 0;
  for (const auto& kv : m->cells) {
    if (k >= cap) break;
    const VoxelCell& c = kv.second;
    out[3 * k] = static_cast<float>(c.sx / c.count);
    out[3 * k + 1] = static_cast<float>(c.sy / c.count);
    out[3 * k + 2] = static_cast<float>(c.sz / c.count);
    ++k;
  }
  return k;
}

int lio_map_save_pcd(void* handle, const char* path) {
  auto* m = static_cast<VoxelMap*>(handle);
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  const uint64_t n = m->cells.size();
  std::fprintf(f,
               "# .PCD v0.7 - Point Cloud Data file format\n"
               "VERSION 0.7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
               "COUNT 1 1 1\nWIDTH %llu\nHEIGHT 1\n"
               "VIEWPOINT 0 0 0 1 0 0 0\nPOINTS %llu\nDATA binary\n",
               (unsigned long long)n, (unsigned long long)n);
  for (const auto& kv : m->cells) {
    const VoxelCell& c = kv.second;
    float p[3] = {static_cast<float>(c.sx / c.count),
                  static_cast<float>(c.sy / c.count),
                  static_cast<float>(c.sz / c.count)};
    std::fwrite(p, sizeof(float), 3, f);
  }
  std::fclose(f);
  return 0;
}

void lio_map_free(void* handle) { delete static_cast<VoxelMap*>(handle); }

// ===========================================================================
// 3. Measurement queue (MeasurementManager equivalent)
// ===========================================================================

struct ImuMsg {
  double t;
  float acc[3];
  float gyr[3];
};

struct MeasurementQueue {
  std::deque<ImuMsg> imu;
  std::deque<std::pair<double, int64_t>> sweeps;  // (stamp, user id)
  double msg_time_delay = 0.0;
  double last_imu_t = -1.0;
  std::mutex mu;
};

void* lio_mq_create(double msg_time_delay) {
  auto* q = new MeasurementQueue();
  q->msg_time_delay = msg_time_delay;
  return q;
}

int lio_mq_push_imu(void* handle, double t, const float* acc, const float* gyr) {
  auto* q = static_cast<MeasurementQueue*>(handle);
  std::lock_guard<std::mutex> lk(q->mu);
  if (t <= q->last_imu_t) return -1;  // out-of-order rejection (MeasurementManager.cc:111-114)
  q->last_imu_t = t;
  ImuMsg m;
  m.t = t;
  std::memcpy(m.acc, acc, sizeof(m.acc));
  std::memcpy(m.gyr, gyr, sizeof(m.gyr));
  q->imu.push_back(m);
  return 0;
}

int lio_mq_push_sweep(void* handle, double t, int64_t id) {
  auto* q = static_cast<MeasurementQueue*>(handle);
  std::lock_guard<std::mutex> lk(q->mu);
  q->sweeps.emplace_back(t, id);
  return 0;
}

// Pairs the oldest sweep with all IMU msgs up to stamp+delay plus ONE after
// (for interpolation, MeasurementManager.cc:54-108). Returns the number of
// IMU samples written (<= cap), with *id_out/*t_out describing the sweep;
// -1 if no complete pair is available yet; drops sweeps with no leading IMU.
int lio_mq_next_pair(void* handle, double* t_out, int64_t* id_out,
                     double* imu_t, float* imu_acc, float* imu_gyr, int cap) {
  auto* q = static_cast<MeasurementQueue*>(handle);
  std::lock_guard<std::mutex> lk(q->mu);
  while (true) {
    if (q->sweeps.empty() || q->imu.empty()) return -1;
    const double stamp = q->sweeps.front().first + q->msg_time_delay;
    if (q->imu.back().t <= stamp) return -1;  // wait for one IMU past the sweep
    if (q->imu.front().t >= stamp) {
      // sweep too old relative to IMU stream: drop it (":97-100")
      q->sweeps.pop_front();
      continue;
    }
    *t_out = q->sweeps.front().first;
    *id_out = q->sweeps.front().second;
    q->sweeps.pop_front();
    int n = 0;
    while (!q->imu.empty() && q->imu.front().t < stamp && n < cap) {
      const ImuMsg& m = q->imu.front();
      imu_t[n] = m.t;
      std::memcpy(imu_acc + 3 * n, m.acc, sizeof(m.acc));
      std::memcpy(imu_gyr + 3 * n, m.gyr, sizeof(m.gyr));
      q->imu.pop_front();
      ++n;
    }
    // one sample after the stamp, kept in the queue (for interpolation)
    if (!q->imu.empty() && n < cap) {
      const ImuMsg& m = q->imu.front();
      imu_t[n] = m.t;
      std::memcpy(imu_acc + 3 * n, m.acc, sizeof(m.acc));
      std::memcpy(imu_gyr + 3 * n, m.gyr, sizeof(m.gyr));
      ++n;
    }
    return n;
  }
}

void lio_mq_free(void* handle) { delete static_cast<MeasurementQueue*>(handle); }

}  // extern "C"
