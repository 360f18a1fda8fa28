// The spacing of the scan states that training keeps, one decision shared
// by the forward (mamba_scan.cu writes h at the start of every chunk of
// kStateChunk steps), the backward (mamba_scan_bwd.cu walks chunks of that
// many steps from them) and the plain versions (ref.STATE_CHUNK, which
// ops.py holds against mamba_scan_state_chunk() when it loads the
// library).
#pragma once

constexpr int kStateChunk = 16;
