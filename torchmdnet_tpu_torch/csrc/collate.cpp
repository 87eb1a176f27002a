// Native batch collation: the host-side hot path of the data loader.
//
// The port's copy of the JAX package's engine
// (torchmdnet_tpu/data/native/collate.cpp), writing the dtypes of the port's
// numpy path (torchmdnet_tpu_torch/data/batch.py:pad_molecules): int64 atomic
// numbers and molecule ids, one byte per mask entry (torch.bool), float32
// everything else.  Built by the host compiler at first use
// (ops/kernels/build.py), loaded with ctypes (data/native_collate.py).
//
// Layout contract: the atoms of molecule m occupy slots [offsets[m],
// offsets[m+1]) of the concatenated inputs and go to consecutive output
// slots from the running fill position; padding atoms carry z = 0, pos = 0,
// batch = num_mol (the trash segment) and atom_mask = 0; padding molecules
// mol_mask = 0 and zero labels.

#include <cstdint>
#include <cstring>

extern "C" {

// Returns 0 on success, -1 if the batch exceeds a capacity.
int pad_collate(
    // ragged inputs (concatenated over molecules)
    const int64_t* z_concat,        // (total_atoms,)
    const float* pos_concat,        // (total_atoms, 3)
    const float* y,                 // (n_mols,) or nullptr
    const float* neg_dy_concat,     // (total_atoms, 3) or nullptr
    const float* q,                 // (n_mols,) or nullptr
    const float* s,                 // (n_mols,) or nullptr
    const float* pq_concat,         // (total_atoms,) or nullptr
    const int64_t* offsets,         // (n_mols + 1,)
    int64_t n_mols,
    // static capacities
    int64_t num_atoms,
    int64_t num_mol,
    // outputs (allocated by the caller)
    int64_t* z_out,                 // (num_atoms,)
    float* pos_out,                 // (num_atoms, 3)
    int64_t* batch_out,             // (num_atoms,)
    uint8_t* atom_mask_out,         // (num_atoms,)
    uint8_t* mol_mask_out,          // (num_mol,)
    float* y_out,                   // (num_mol, 1) or nullptr
    float* neg_dy_out,              // (num_atoms, 3) or nullptr
    float* q_out,                   // (num_mol,) or nullptr
    float* s_out,                   // (num_mol,) or nullptr
    float* pq_out                   // (num_atoms,) or nullptr
) {
    const int64_t total = offsets[n_mols];
    if (total > num_atoms || n_mols > num_mol) return -1;

    // padding defaults
    std::memset(z_out, 0, sizeof(int64_t) * num_atoms);
    std::memset(pos_out, 0, sizeof(float) * num_atoms * 3);
    std::memset(atom_mask_out, 0, num_atoms);
    std::memset(mol_mask_out, 0, num_mol);
    for (int64_t i = 0; i < num_atoms; ++i) batch_out[i] = num_mol;
    if (y_out) std::memset(y_out, 0, sizeof(float) * num_mol);
    if (neg_dy_out) std::memset(neg_dy_out, 0, sizeof(float) * num_atoms * 3);
    if (q_out) std::memset(q_out, 0, sizeof(float) * num_mol);
    if (s_out) std::memset(s_out, 0, sizeof(float) * num_mol);
    if (pq_out) std::memset(pq_out, 0, sizeof(float) * num_atoms);

    int64_t fill = 0;
    for (int64_t m = 0; m < n_mols; ++m) {
        const int64_t lo = offsets[m];
        const int64_t n = offsets[m + 1] - lo;
        std::memcpy(z_out + fill, z_concat + lo, sizeof(int64_t) * n);
        for (int64_t i = 0; i < n; ++i) batch_out[fill + i] = m;
        std::memset(atom_mask_out + fill, 1, n);
        std::memcpy(pos_out + fill * 3, pos_concat + lo * 3, sizeof(float) * n * 3);
        if (neg_dy_out && neg_dy_concat)
            std::memcpy(neg_dy_out + fill * 3, neg_dy_concat + lo * 3, sizeof(float) * n * 3);
        if (pq_out && pq_concat)
            std::memcpy(pq_out + fill, pq_concat + lo, sizeof(float) * n);
        mol_mask_out[m] = 1;
        if (y_out && y) y_out[m] = y[m];
        if (q_out && q) q_out[m] = q[m];
        if (s_out && s) s_out[m] = s[m];
        fill += n;
    }
    return 0;
}

}  // extern "C"
