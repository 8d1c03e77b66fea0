// K2's split kernel for f32 queries over an int8 pool (K4): every head dim
// and group of paged_attention_split.cuh, in a file of its own so that nvcc
// builds the six (query, payload) pairs in parallel.
#include "paged_attention_split.cuh"

template cudaError_t repro::launch_split<float, int8_t>(
    const repro::PaParams&, int, int, int, cudaStream_t);
