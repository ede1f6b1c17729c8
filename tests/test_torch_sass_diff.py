"""apps/sass_diff.py's listing normalization and comparison, on the CPU (the
compile and ``cuobjdump`` steps need the CUDA toolkit and run on the card
machine)."""

from threedhumangan_tpu_torch.apps import sass_diff

KERNEL = "14half_block_bwdILi4ELi16EEEvNS_4ArgsE"


def test_anonymous_namespace_names_become_one_token():
    """nvcc names an anonymous namespace by two hashes around the file's
    name; two builds of one file compare equal once both are replaced."""
    a = f"_ZN55_GLOBAL__N__5b1c8a4f_22_synthesis_train_bwd_cu_92f393d8{KERNEL}"
    b = f"_ZN55_GLOBAL__N__0d2e7c11_22_synthesis_train_bwd_cu_92f393d8{KERNEL}"
    assert sass_diff._ANON.sub("ANON", a) == sass_diff._ANON.sub("ANON", b) == "_ZNANON" + KERNEL


def test_compare_counts_instructions_and_differing_lines():
    other = {"k1": ["MOV R1, R2", "IADD R3, R1, R2", "EXIT"], "k2": ["EXIT"]}
    this = {"k1": ["MOV R1, R2", "IADD R3, R1, R4", "EXIT"], "k2": ["EXIT"], "k3": ["NOP", "EXIT"]}
    res = sass_diff.compare(other, this)
    assert res["functions"] == {"k1": [3, 3], "k2": [1, 1], "k3": [0, 2]}
    assert res["instructions"] == [4, 6]
    assert res["differing_lines"] == 1 + 2
    assert sass_diff.compare(other, other)["differing_lines"] == 0


def test_rename_maps_a_renamed_kernel_onto_its_new_name():
    """A kernel renamed between the two sides (a template's name and its
    first argument's kind) compares equal once the other side's names are
    mapped; a mapping that matches nothing leaves the names as they were."""
    old = "_ZNANON16field_bwd_kernelILb1ELb0EEEvNS_4ArgsE"
    new = "_ZNANON12field_kernelILi1ELb0EEEvNS_4ArgsE"
    other, this = {old: ["MOV R1, R2", "EXIT"]}, {new: ["MOV R1, R2", "EXIT"]}
    assert sass_diff.compare(other, this)["differing_lines"] == 4
    mapped = sass_diff.rename(other, [("16field_bwd_kernelILb1E", "12field_kernelILi1E")])
    assert mapped == this and sass_diff.compare(mapped, this)["differing_lines"] == 0
    assert sass_diff.rename(other, [("nothing", "else")]) == other
