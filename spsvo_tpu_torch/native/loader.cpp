// Asynchronous stereo frame loader (C ABI, loaded with ctypes by
// spsvo_tpu_torch/io/loader.py; no Python.h).
//
// A pool of worker threads decodes stereo PNG pairs with OpenCV and
// preprocesses them ahead of the consumer into a bounded ring buffer that
// hands the frames out in order. Preprocessing is the OpenCV host route's
// (ops/image.py: preprocess_u8_cv2): centre-crop to the target aspect ratio,
// bilinear resize (cv::INTER_LINEAR) of the uint8 image, float32 in [0, 1]
// (or 0-255 without normalisation).
//
// An image that cannot be decoded is reported to the consumer:
// spsvo_loader_next returns -(idx + 2) for frame idx.

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include <opencv2/imgcodecs.hpp>
#include <opencv2/imgproc.hpp>

namespace {

struct Slot {
  std::vector<float> data;  // 2 * dst_h * dst_w
  std::atomic<int64_t> frame_idx{-1};  // which frame occupies the slot
  std::atomic<bool> ready{false};
  bool failed = false;  // a decode error: the consumer is told
};

struct Loader {
  std::vector<std::string> left_paths;
  std::vector<std::string> right_paths;
  int dst_h = 0, dst_w = 0;
  bool normalize = true;

  std::vector<Slot> ring;
  std::atomic<int64_t> next_to_produce{0};
  std::atomic<int64_t> next_to_consume{0};
  std::atomic<bool> stop{false};
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv_ready;
  std::condition_variable cv_free;

  size_t n_frames() const { return left_paths.size(); }
  size_t cap() const { return ring.size(); }
};

void preprocess_into(const cv::Mat& src, int dst_h, int dst_w, bool normalize,
                     float* out) {
  // centre-crop to the target aspect ratio (integer arithmetic as in
  // ops/image.py::crop_geometry)
  int src_h = src.rows, src_w = src.cols;
  double real_ar = static_cast<double>(src_w) / src_h;
  double want_ar = static_cast<double>(dst_w) / dst_h;
  int row_off = 0, col_off = 0, crop_h = src_h, crop_w = src_w;
  if (want_ar > real_ar) {
    crop_h = static_cast<int>(src_w / want_ar);
    row_off = (src_h - crop_h) / 2;
  } else if (want_ar < real_ar) {
    crop_w = static_cast<int>(src_h * want_ar);
    col_off = (src_w - crop_w) / 2;
  }
  cv::Mat cropped = src(cv::Rect(col_off, row_off, crop_w, crop_h));
  cv::Mat resized;
  if (crop_h != dst_h || crop_w != dst_w) {
    cv::resize(cropped, resized, cv::Size(dst_w, dst_h), 0, 0,
               cv::INTER_LINEAR);
  } else {
    resized = cropped;
  }
  cv::Mat out_mat(dst_h, dst_w, CV_32F, out);
  resized.convertTo(out_mat, CV_32F, normalize ? 1.0 / 255.0 : 1.0);
}

void worker_loop(Loader* L) {
  const size_t frame_bytes = static_cast<size_t>(L->dst_h) * L->dst_w;
  while (!L->stop.load(std::memory_order_acquire)) {
    int64_t idx = L->next_to_produce.fetch_add(1, std::memory_order_acq_rel);
    if (idx >= static_cast<int64_t>(L->n_frames())) return;
    Slot& slot = L->ring[idx % L->cap()];

    // wait until the consumer has drained whatever lives in this slot
    {
      std::unique_lock<std::mutex> lk(L->mu);
      L->cv_free.wait(lk, [&] {
        return L->stop.load(std::memory_order_acquire) ||
               idx - L->next_to_consume.load(std::memory_order_acquire) <
                   static_cast<int64_t>(L->cap());
      });
      if (L->stop.load(std::memory_order_acquire)) return;
    }

    cv::Mat img_l = cv::imread(L->left_paths[idx], cv::IMREAD_GRAYSCALE);
    cv::Mat img_r = cv::imread(L->right_paths[idx], cv::IMREAD_GRAYSCALE);
    slot.failed = img_l.empty() || img_r.empty();
    if (slot.failed) {
      std::memset(slot.data.data(), 0, slot.data.size() * sizeof(float));
    } else {
      preprocess_into(img_l, L->dst_h, L->dst_w, L->normalize,
                      slot.data.data());
      preprocess_into(img_r, L->dst_h, L->dst_w, L->normalize,
                      slot.data.data() + frame_bytes);
    }
    // publish under the mutex: a waiter checks the predicate while holding
    // the lock, so a store made inside it can never slip into the waiter's
    // check-then-block window (missed-wakeup race on the final in-flight
    // frame otherwise).
    {
      std::lock_guard<std::mutex> lk(L->mu);
      slot.frame_idx.store(idx, std::memory_order_release);
      slot.ready.store(true, std::memory_order_release);
    }
    L->cv_ready.notify_all();
  }
}

}  // namespace

extern "C" {

void* spsvo_loader_create(const char** left_paths, const char** right_paths,
                          int n, int dst_h, int dst_w, int queue_capacity,
                          int num_threads, int normalize) {
  auto* L = new Loader();
  L->left_paths.assign(left_paths, left_paths + n);
  L->right_paths.assign(right_paths, right_paths + n);
  L->dst_h = dst_h;
  L->dst_w = dst_w;
  L->normalize = normalize != 0;
  L->ring = std::vector<Slot>(std::max(2, queue_capacity));
  for (auto& s : L->ring)
    s.data.resize(static_cast<size_t>(2) * dst_h * dst_w);
  int threads = std::max(1, num_threads);
  for (int i = 0; i < threads; ++i) L->workers.emplace_back(worker_loop, L);
  return L;
}

// Blocks until the next frame (in order) is ready; copies 2*H*W floats into
// `out`. Returns the frame index, -(index + 2) when one of its images could
// not be decoded, or -1 when the sequence is exhausted.
int64_t spsvo_loader_next(void* handle, float* out) {
  auto* L = static_cast<Loader*>(handle);
  int64_t idx = L->next_to_consume.load(std::memory_order_acquire);
  if (idx >= static_cast<int64_t>(L->n_frames())) return -1;
  Slot& slot = L->ring[idx % L->cap()];
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->cv_ready.wait(lk, [&] {
      return L->stop.load(std::memory_order_acquire) ||
             (slot.ready.load(std::memory_order_acquire) &&
              slot.frame_idx.load(std::memory_order_acquire) == idx);
    });
  }
  if (L->stop.load(std::memory_order_acquire)) return -1;
  std::memcpy(out, slot.data.data(), slot.data.size() * sizeof(float));
  const bool failed = slot.failed;
  {
    // see worker_loop: predicate state must change under the mutex so a
    // worker blocked in cv_free.wait cannot miss the wakeup.
    std::lock_guard<std::mutex> lk(L->mu);
    slot.ready.store(false, std::memory_order_release);
    L->next_to_consume.fetch_add(1, std::memory_order_acq_rel);
  }
  L->cv_free.notify_all();
  return failed ? -(idx + 2) : idx;
}

void spsvo_loader_destroy(void* handle) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop.store(true, std::memory_order_release);
  }
  L->cv_ready.notify_all();
  L->cv_free.notify_all();
  for (auto& t : L->workers) t.join();
  delete L;
}

}  // extern "C"
