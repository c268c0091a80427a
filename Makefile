# Developer entry points.

.PHONY: test native bench demo demo-multichip clean

test:
	python -m pytest tests/ -q

native:
	$(MAKE) -C native

bench:
	python bench.py

demo:
	python examples/groovebox_demo.py groovebox_demo.wav

demo-multichip:
	python examples/multichip_demo.py multichip_demo.wav

clean:
	$(MAKE) -C native clean
	rm -f native/zl_hostcore.so
