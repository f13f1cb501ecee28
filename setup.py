from setuptools import setup, find_packages

setup(
    name="rafft_tpu",
    version="0.1.0",
    description="TPU-native RNA fast-folding framework "
                "(FFT-based folding paths + kinetics)",
    packages=find_packages(include=["rafft_tpu", "rafft_tpu.*",
                                    "rafft_tpu_torch", "rafft_tpu_torch.*"]),
    package_data={"rafft_tpu_torch": ["csrc/*.cu", "native/*.cpp",
                                      "testdata/*.json"]},
    scripts=["bin/rafft", "bin/rafft_kin"],
    entry_points={"console_scripts": [
        "rafft-torch = rafft_tpu_torch.cli.fold_cli:main",
        "rafft-kin-torch = rafft_tpu_torch.cli.kin_cli:main",
    ]},
    python_requires=">=3.10",
    install_requires=["numpy", "scipy"],
    extras_require={
        "tpu": ["jax"],
        "torch": ["torch"],
        "viz": ["matplotlib", "scikit-learn"],
    },
)
