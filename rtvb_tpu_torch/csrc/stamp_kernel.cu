// The tracer's device stamp (rtvb_tpu_torch/utils/perf.py `Stamps`): one
// thread writes the device's nanosecond timer (%globaltimer) into slot i
// of a pinned host buffer mapped into the device's address space, so that
// the host reads a frame's stamps after its synchronize with no CUDA call.
// The frame's first stamp counts the frame in `seq` (device memory); its
// last writes that count after the times, behind a system fence, so a
// reading whose count is the number of frames run is complete and is this
// frame's.  Recorded in a frame body that a CUDA graph captures, each
// stamp is a kernel node and fires at every replay.
//
// Replaces no TPU kernel.  Timing events recorded in a capture also fire
// at every replay, but reading a frame's five of them (elapsed_time, ~5–8
// µs a call on the card's host) costs the host ~90 µs a frame.
//
// What bounds it: one launch's latency; it moves 56 bytes.
#include "common.cuh"

namespace {

__global__ void stamp_kernel(unsigned long long* slots,
                             unsigned long long* seq, int i, int last) {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  slots[i] = t;
  if (i == 0) *seq += 1ull;
  if (i == last) {
    __threadfence_system();
    slots[last + 1] = *seq;
  }
}

}  // namespace

RTVB_EXPORT int rtvb_stamp(void* slots, void* seq, int i, int last,
                          void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(slots),
      static_cast<unsigned long long*>(seq), i, last);
  return static_cast<int>(cudaGetLastError());
}

// The device's address of a pinned host buffer (the same address under
// unified addressing; asked all the same).
RTVB_EXPORT int rtvb_mapped_pointer(void* host, void** device) {
  return static_cast<int>(cudaHostGetDevicePointer(device, host, 0));
}
