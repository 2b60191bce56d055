// Native graph-store core for arslam.
//
// The reference keeps its constraint graph in C++ (ArSlamSolver's deques +
// uid->handle hash maps, ar_slam_util.hpp:477-492).  This is the
// equivalent here: a host-side C++ engine owning the capture/tag/block tables,
// uid interning, adjacency, BFS ordering with init-block assignment
// (≙ addConnectedCaptures, ar_slam_util.cpp:869-885), and padded
// block-array export for the device solver — exposed through a C ABI for
// ctypes.  Python's MapStore delegates here when the native library is
// built (python fallback keeps identical semantics).
//
// Build: see native/Makefile (g++ -O2 -shared -fPIC).

#include <cstdint>
#include <cstring>
#include <deque>
#include <optional>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct Capture {
  std::string uid;
  std::string img_fn;
  double inv_pose[6] = {0, 0, 0, 0, 0, 0};
  std::vector<int32_t> blocks;
  int32_t init_block = -1;  // -1 = unset, -2 = seed sentinel
};

struct Aruco {
  std::string id;
  double pose[6] = {0, 0, 0, 0, 0, 0};
  bool initialized = false;
  std::vector<int32_t> blocks;
};

struct Block {
  int32_t cap_idx;
  int32_t tag_idx;
  double corners[8];
};

struct GraphCore {
  std::deque<Capture> captures;
  std::deque<Aruco> arucos;
  std::deque<Block> blocks;
  std::unordered_map<std::string, int32_t> capture_map;
  std::unordered_map<std::string, int32_t> aruco_map;
  double camera[3] = {3000.0, 0.0, 0.0};
  int32_t width = -1, height = -1;
};

}  // namespace

extern "C" {

GraphCore* arslam_graph_new() { return new GraphCore(); }

void arslam_graph_free(GraphCore* g) { delete g; }

int32_t arslam_num_captures(GraphCore* g) {
  return static_cast<int32_t>(g->captures.size());
}
int32_t arslam_num_arucos(GraphCore* g) {
  return static_cast<int32_t>(g->arucos.size());
}
int32_t arslam_num_blocks(GraphCore* g) {
  return static_cast<int32_t>(g->blocks.size());
}

// Returns capture index, or -1 if the uid already exists.
int32_t arslam_add_capture(GraphCore* g, const char* uid, const char* img_fn) {
  std::string key(uid);
  if (g->capture_map.count(key)) return -1;
  int32_t idx = static_cast<int32_t>(g->captures.size());
  g->captures.emplace_back();
  g->captures.back().uid = key;
  g->captures.back().img_fn = img_fn ? img_fn : "";
  g->capture_map.emplace(std::move(key), idx);
  return idx;
}

int32_t arslam_find_capture(GraphCore* g, const char* uid) {
  auto it = g->capture_map.find(uid);
  return it == g->capture_map.end() ? -1 : it->second;
}

int32_t arslam_get_or_add_aruco(GraphCore* g, const char* id) {
  std::string key(id);
  auto it = g->aruco_map.find(key);
  if (it != g->aruco_map.end()) return it->second;
  int32_t idx = static_cast<int32_t>(g->arucos.size());
  g->arucos.emplace_back();
  g->arucos.back().id = key;
  g->aruco_map.emplace(std::move(key), idx);
  return idx;
}

int32_t arslam_find_aruco(GraphCore* g, const char* id) {
  auto it = g->aruco_map.find(id);
  return it == g->aruco_map.end() ? -1 : it->second;
}

int32_t arslam_add_block(GraphCore* g, int32_t cap_idx, int32_t tag_idx,
                         const double* corners8) {
  int32_t idx = static_cast<int32_t>(g->blocks.size());
  g->blocks.emplace_back();
  Block& b = g->blocks.back();
  b.cap_idx = cap_idx;
  b.tag_idx = tag_idx;
  std::memcpy(b.corners, corners8, 8 * sizeof(double));
  g->captures[cap_idx].blocks.push_back(idx);
  g->arucos[tag_idx].blocks.push_back(idx);
  return idx;
}

void arslam_bulk_add_blocks(GraphCore* g, int32_t n, const int32_t* cap_idx,
                            const int32_t* tag_idx, const double* corners) {
  for (int32_t k = 0; k < n; ++k) {
    int32_t idx = static_cast<int32_t>(g->blocks.size());
    g->blocks.emplace_back();
    Block& b = g->blocks.back();
    b.cap_idx = cap_idx[k];
    b.tag_idx = tag_idx[k];
    std::memcpy(b.corners, corners + 8 * k, 8 * sizeof(double));
    g->captures[b.cap_idx].blocks.push_back(idx);
    g->arucos[b.tag_idx].blocks.push_back(idx);
  }
}

void arslam_set_camera(GraphCore* g, const double* params3, int32_t w,
                       int32_t h) {
  std::memcpy(g->camera, params3, 3 * sizeof(double));
  g->width = w;
  g->height = h;
}

void arslam_get_camera(GraphCore* g, double* params3, int32_t* wh) {
  std::memcpy(params3, g->camera, 3 * sizeof(double));
  wh[0] = g->width;
  wh[1] = g->height;
}

void arslam_set_capture_pose(GraphCore* g, int32_t idx, const double* pose6) {
  std::memcpy(g->captures[idx].inv_pose, pose6, 6 * sizeof(double));
}
void arslam_get_capture_pose(GraphCore* g, int32_t idx, double* pose6) {
  std::memcpy(pose6, g->captures[idx].inv_pose, 6 * sizeof(double));
}
void arslam_set_tag_pose(GraphCore* g, int32_t idx, const double* pose6) {
  std::memcpy(g->arucos[idx].pose, pose6, 6 * sizeof(double));
}
void arslam_get_tag_pose(GraphCore* g, int32_t idx, double* pose6) {
  std::memcpy(pose6, g->arucos[idx].pose, 6 * sizeof(double));
}

const char* arslam_capture_uid(GraphCore* g, int32_t idx) {
  return g->captures[idx].uid.c_str();
}
const char* arslam_capture_img_fn(GraphCore* g, int32_t idx) {
  return g->captures[idx].img_fn.c_str();
}
const char* arslam_aruco_id(GraphCore* g, int32_t idx) {
  return g->arucos[idx].id.c_str();
}

int32_t arslam_capture_num_blocks(GraphCore* g, int32_t idx) {
  return static_cast<int32_t>(g->captures[idx].blocks.size());
}

// Seed selection: first capture with the max block count
// (≙ ar_slam_util.cpp:759-771).
int32_t arslam_capture_with_most_blocks(GraphCore* g) {
  if (g->captures.empty()) return -1;
  int32_t best = 0;
  size_t best_n = g->captures[0].blocks.size();
  for (size_t i = 1; i < g->captures.size(); ++i) {
    if (g->captures[i].blocks.size() > best_n) {
      best_n = g->captures[i].blocks.size();
      best = static_cast<int32_t>(i);
    }
  }
  return best;
}

// BFS over the capture-tag bipartite graph from seed_cap.  Writes the visit
// order into order_out (size >= num_captures) and each visited capture's
// init block into init_blocks_out (-1 for the seed).  Returns the number of
// captures visited.  Resets prior init_block marks first (fresh BFS).
int32_t arslam_bfs_order(GraphCore* g, int32_t seed_cap, int32_t* order_out,
                         int32_t* init_blocks_out) {
  for (auto& c : g->captures) c.init_block = -1;
  if (seed_cap < 0 || seed_cap >= (int32_t)g->captures.size()) return 0;
  int32_t count = 0;
  std::deque<int32_t> queue;
  g->captures[seed_cap].init_block = -2;
  order_out[count] = seed_cap;
  init_blocks_out[count] = -1;
  ++count;
  queue.push_back(seed_cap);
  while (!queue.empty()) {
    int32_t ci = queue.front();
    queue.pop_front();
    for (int32_t bh : g->captures[ci].blocks) {
      Aruco& tag = g->arucos[g->blocks[bh].tag_idx];
      for (int32_t tbh : tag.blocks) {
        Capture& other = g->captures[g->blocks[tbh].cap_idx];
        if (other.init_block == -1) {
          other.init_block = tbh;
          order_out[count] = g->blocks[tbh].cap_idx;
          init_blocks_out[count] = tbh;
          ++count;
          queue.push_back(g->blocks[tbh].cap_idx);
        }
      }
    }
  }
  return count;
}

// Bulk export of the block table into pre-allocated arrays (padded rows
// beyond num_blocks are left to the caller).
void arslam_export_blocks(GraphCore* g, int32_t* cap_idx, int32_t* tag_idx,
                          double* corners) {
  for (size_t i = 0; i < g->blocks.size(); ++i) {
    cap_idx[i] = g->blocks[i].cap_idx;
    tag_idx[i] = g->blocks[i].tag_idx;
    std::memcpy(corners + 8 * i, g->blocks[i].corners, 8 * sizeof(double));
  }
}

void arslam_export_poses(GraphCore* g, double* cap_poses, double* tag_poses) {
  for (size_t i = 0; i < g->captures.size(); ++i)
    std::memcpy(cap_poses + 6 * i, g->captures[i].inv_pose,
                6 * sizeof(double));
  for (size_t i = 0; i < g->arucos.size(); ++i)
    std::memcpy(tag_poses + 6 * i, g->arucos[i].pose, 6 * sizeof(double));
}

void arslam_import_poses(GraphCore* g, const double* camera,
                         const double* cap_poses, const double* tag_poses) {
  std::memcpy(g->camera, camera, 3 * sizeof(double));
  for (size_t i = 0; i < g->captures.size(); ++i)
    std::memcpy(g->captures[i].inv_pose, cap_poses + 6 * i,
                6 * sizeof(double));
  for (size_t i = 0; i < g->arucos.size(); ++i)
    std::memcpy(g->arucos[i].pose, tag_poses + 6 * i, 6 * sizeof(double));
}

// Block indices of one capture into out (size >= its block count).
void arslam_capture_blocks(GraphCore* g, int32_t cap_idx, int32_t* out) {
  const auto& v = g->captures[cap_idx].blocks;
  std::memcpy(out, v.data(), v.size() * sizeof(int32_t));
}

int32_t arslam_block_info(GraphCore* g, int32_t block_idx, int32_t* cap_idx,
                          int32_t* tag_idx, double* corners8) {
  if (block_idx < 0 || block_idx >= (int32_t)g->blocks.size()) return -1;
  const Block& b = g->blocks[block_idx];
  *cap_idx = b.cap_idx;
  *tag_idx = b.tag_idx;
  std::memcpy(corners8, b.corners, 8 * sizeof(double));
  return 0;
}

}  // extern "C"
