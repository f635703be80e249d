// Native runtime core for flexflow_tpu.
//
// TPU-native equivalents of the reference's host-side C++ runtime pieces:
//  * gather_rows: multithreaded batch gather/staging — the hot loop of the
//    dataloader (reference: python/flexflow_dataloader.cc:574, which stages
//    batches from zero-copy memory with index-launched copies; here the
//    host-side gather feeding jax.device_put).
//  * simulate_taskgraph: event-driven list-scheduling simulation of a task
//    graph with per-task costs and dependency edges — the inner loop of the
//    strategy simulator (reference: Simulator::simulate_runtime,
//    src/runtime/simulator.cc:815), called thousands of times by the search.
//
// Built as a plain shared library, loaded via ctypes (no pybind11 in image).
#include <algorithm>
#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <queue>
#include <thread>
#include <vector>

extern "C" {

// Gather rows from src into dst: dst[i] = src[indices[i]] for row_bytes-sized
// rows. Multithreaded memcpy; returns 0 on success.
int gather_rows(const void* src, const int64_t* indices, void* dst,
                int64_t n_rows, int64_t row_bytes, int n_threads) {
  if (!src || !dst || !indices || n_rows < 0 || row_bytes <= 0) return -1;
  if (n_threads <= 0) n_threads = 1;
  n_threads = std::min<int64_t>(n_threads, std::max<int64_t>(n_rows, 1));
  const char* s = static_cast<const char*>(src);
  char* d = static_cast<char*>(dst);

  auto worker = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; ++i) {
      std::memcpy(d + i * row_bytes, s + indices[i] * row_bytes, row_bytes);
    }
  };
  if (n_threads == 1) {
    worker(0, n_rows);
    return 0;
  }
  std::vector<std::thread> threads;
  int64_t chunk = (n_rows + n_threads - 1) / n_threads;
  for (int t = 0; t < n_threads; ++t) {
    int64_t lo = t * chunk;
    int64_t hi = std::min<int64_t>(lo + chunk, n_rows);
    if (lo >= hi) break;
    threads.emplace_back(worker, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

// Event-driven simulation of a task graph (list scheduling).
//   n_tasks: number of tasks; costs[i]: execution time of task i
//   device[i]: device id executing task i (tasks on one device serialize)
//   n_edges edges src[e] -> dst[e] (dst depends on src)
// Returns the makespan, or -1 on error (e.g. cycle).
double simulate_taskgraph(int64_t n_tasks, const double* costs,
                          const int32_t* device, int32_t n_devices,
                          int64_t n_edges, const int32_t* esrc,
                          const int32_t* edst) {
  if (n_tasks <= 0) return 0.0;
  if (!costs || !device || n_devices <= 0) return -1.0;
  for (int64_t i = 0; i < n_tasks; ++i)
    if (device[i] < 0 || device[i] >= n_devices) return -1.0;
  std::vector<std::vector<int32_t>> out(n_tasks);
  std::vector<int32_t> indeg(n_tasks, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    if (esrc[e] < 0 || esrc[e] >= n_tasks || edst[e] < 0 ||
        edst[e] >= n_tasks)
      return -1.0;
    out[esrc[e]].push_back(edst[e]);
    indeg[edst[e]]++;
  }
  // ready time per task (dependency-driven), busy-until per device
  std::vector<double> ready(n_tasks, 0.0);
  std::vector<double> dev_free(n_devices, 0.0);
  // priority queue of (ready_time, task) over tasks with indeg 0
  using QE = std::pair<double, int32_t>;
  std::priority_queue<QE, std::vector<QE>, std::greater<QE>> q;
  for (int64_t i = 0; i < n_tasks; ++i)
    if (indeg[i] == 0) q.emplace(0.0, (int32_t)i);
  double makespan = 0.0;
  int64_t done = 0;
  while (!q.empty()) {
    auto [rt, t] = q.top();
    q.pop();
    int32_t dev = device[t];
    double start = std::max(rt, dev_free[dev]);
    double finish = start + costs[t];
    dev_free[dev] = finish;
    makespan = std::max(makespan, finish);
    ++done;
    for (int32_t c : out[t]) {
      ready[c] = std::max(ready[c], finish);
      if (--indeg[c] == 0) q.emplace(ready[c], c);
    }
  }
  if (done != n_tasks) return -1.0;  // cycle
  return makespan;
}

// ---------------------------------------------------------------------------
// Batch pipeline: double-buffered multi-array shuffled-batch staging with a
// background gather thread — the dataloader's "stage next batch while the
// device runs the current one" loop (reference: the index-launched batch copy
// in python/flexflow_dataloader.cc:208 overlapping with compute).
// ---------------------------------------------------------------------------

struct BatchPipeline {
  std::vector<const char*> srcs;
  std::vector<int64_t> row_bytes;
  std::vector<int64_t> indices;
  int64_t batch_size = 0;
  int64_t num_batches = 0;
  int n_threads = 1;

  // two buffer sets; buffers[s][a] holds batch_size rows of array a
  std::vector<std::vector<std::vector<char>>> buffers;
  int64_t produced = 0;  // next batch index the worker will fill
  int64_t consumed = 0;  // first batch index NOT yet released by the consumer
  int64_t handed = -1;   // batch the consumer currently holds pointers into
  bool stop = false;
  std::mutex mu;
  std::condition_variable cv_produce, cv_consume;
  std::thread worker;

  void gather_batch(int64_t b, int slot) {
    const int64_t lo = b * batch_size;
    const int64_t hi = std::min<int64_t>(lo + batch_size,
                                         (int64_t)indices.size());
    for (size_t a = 0; a < srcs.size(); ++a) {
      char* dst = buffers[slot][a].data();
      const char* s = srcs[a];
      const int64_t rb = row_bytes[a];
      gather_rows(s, indices.data() + lo, dst, hi - lo, rb, n_threads);
    }
  }

  void run() {
    while (true) {
      std::unique_lock<std::mutex> lk(mu);
      cv_produce.wait(lk, [&] {
        return stop || (produced < num_batches && produced - consumed < 2);
      });
      if (stop || produced >= num_batches) return;
      int64_t b = produced;
      lk.unlock();
      gather_batch(b, (int)(b % 2));
      lk.lock();
      produced = b + 1;
      cv_consume.notify_one();
    }
  }
};

BatchPipeline* pipeline_create(int n_arrays, const void** srcs,
                               const int64_t* row_bytes,
                               const int64_t* indices, int64_t n_rows,
                               int64_t batch_size, int n_threads) {
  if (n_arrays <= 0 || !srcs || !row_bytes || !indices || n_rows < 0 ||
      batch_size <= 0)
    return nullptr;
  auto* p = new BatchPipeline();
  for (int a = 0; a < n_arrays; ++a) {
    p->srcs.push_back(static_cast<const char*>(srcs[a]));
    p->row_bytes.push_back(row_bytes[a]);
  }
  p->indices.assign(indices, indices + n_rows);
  p->batch_size = batch_size;
  p->num_batches = n_rows / batch_size;  // drop remainder
  p->n_threads = n_threads > 0 ? n_threads : 1;
  p->buffers.resize(2);
  for (int s = 0; s < 2; ++s) {
    p->buffers[s].resize(n_arrays);
    for (int a = 0; a < n_arrays; ++a)
      p->buffers[s][a].resize((size_t)batch_size * row_bytes[a]);
  }
  p->worker = std::thread([p] { p->run(); });
  return p;
}

// Blocks until the next batch is staged; fills out_ptrs with one pointer per
// array into the ready buffer (valid until the NEXT pipeline_next call).
// Returns the batch index, or -1 when exhausted. The buffer slot of the
// PREVIOUSLY returned batch is released here — not when it was handed out —
// so the worker can never overwrite a batch the consumer still holds.
int64_t pipeline_next(BatchPipeline* p, void** out_ptrs) {
  if (!p || !out_ptrs) return -1;
  std::unique_lock<std::mutex> lk(p->mu);
  if (p->handed >= 0) {
    p->consumed = p->handed + 1;
    p->cv_produce.notify_one();
  }
  const int64_t b = (p->handed >= 0) ? p->handed + 1 : 0;
  if (b >= p->num_batches) return -1;
  p->cv_consume.wait(lk, [&] { return p->produced > b; });
  for (size_t a = 0; a < p->srcs.size(); ++a)
    out_ptrs[a] = p->buffers[b % 2][a].data();
  p->handed = b;
  return b;
}

void pipeline_destroy(BatchPipeline* p) {
  if (!p) return;
  {
    std::lock_guard<std::mutex> lk(p->mu);
    p->stop = true;
  }
  p->cv_produce.notify_all();
  if (p->worker.joinable()) p->worker.join();
  delete p;
}

// ---------------------------------------------------------------------------
// Immediate (post-)dominators on an int32 edge-list DAG — the structural
// analysis behind bottleneck-based sequence splits (reference:
// include/flexflow/dominators.h, Graph::find_bottleneck_node). Iterative
// Cooper-Harvey-Kennedy on a reverse-post-order.
// Returns 0 on success; out_idom[i] = immediate dominator, or -1 for roots /
// unreachable nodes. For post-dominators, call with the edge list reversed.
// ---------------------------------------------------------------------------

int imm_dominators_native(int32_t n, int64_t n_edges, const int32_t* esrc,
                          const int32_t* edst, int32_t* out_idom) {
  if (n <= 0 || !out_idom) return -1;
  // virtual super-root R = n with an edge to every real root, so the
  // intersect walk has a single fixed point even with multiple roots
  const int32_t R = n;
  std::vector<std::vector<int32_t>> preds(n + 1), succs(n + 1);
  std::vector<int32_t> indeg(n + 1, 0);
  for (int64_t e = 0; e < n_edges; ++e) {
    if (esrc[e] < 0 || esrc[e] >= n || edst[e] < 0 || edst[e] >= n) return -1;
    preds[edst[e]].push_back(esrc[e]);
    succs[esrc[e]].push_back(edst[e]);
    indeg[edst[e]]++;
  }
  for (int32_t i = 0; i < n; ++i)
    if (preds[i].empty()) {
      preds[i].push_back(R);
      succs[R].push_back(i);
      indeg[i]++;
    }
  // topological order (Kahn); doubles as reverse-post-order for a DAG
  std::vector<int32_t> topo;
  topo.reserve(n + 1);
  std::queue<int32_t> q;
  q.push(R);
  std::vector<int32_t> deg = indeg;
  while (!q.empty()) {
    int32_t u = q.front();
    q.pop();
    topo.push_back(u);
    for (int32_t v : succs[u])
      if (--deg[v] == 0) q.push(v);
  }
  if ((int32_t)topo.size() != n + 1) return -2;  // cycle
  std::vector<int32_t> order(n + 1);
  for (size_t i = 0; i < topo.size(); ++i) order[topo[i]] = (int32_t)i;

  std::vector<int32_t> idom(n + 1, -1);
  idom[R] = R;
  auto intersect = [&](int32_t a, int32_t b) {
    while (a != b) {
      while (order[a] > order[b]) a = idom[a];
      while (order[b] > order[a]) b = idom[b];
    }
    return a;
  };
  bool changed = true;
  while (changed) {
    changed = false;
    for (int32_t u : topo) {
      if (u == R) continue;
      int32_t new_idom = -1;
      for (int32_t p : preds[u]) {
        if (idom[p] == -1) continue;  // not yet processed
        new_idom = (new_idom == -1) ? p : intersect(p, new_idom);
      }
      if (new_idom != -1 && idom[u] != new_idom) {
        idom[u] = new_idom;
        changed = true;
      }
    }
  }
  for (int32_t i = 0; i < n; ++i)
    out_idom[i] = (idom[i] == R || idom[i] == -1) ? -1 : idom[i];
  return 0;
}

}  // extern "C"
