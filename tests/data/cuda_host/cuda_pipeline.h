// Host stand-in for cuda_pipeline.h (tests/test_torch_csrc_host.py): an
// asynchronous copy into shared memory is a synchronous one, so committing
// and waiting have nothing to do.
#pragma once
#include <cstddef>
#include <cstring>

inline void __pipeline_memcpy_async(void* dst, const void* src, size_t size, size_t zfill = 0) {
  std::memcpy(dst, src, size - zfill);
  std::memset(static_cast<char*>(dst) + (size - zfill), 0, zfill);
}
inline void __pipeline_commit() {}
inline void __pipeline_wait_prior(size_t) {}
